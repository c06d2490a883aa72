import pytest

from traffic_sign_detector.config import (
    ClassifierConfig,
    ConfigError,
    MSERConfig,
)


def test_mser_string_roundtrip():
    cfg = MSERConfig.from_string("MSER_7_200_2000_0.15")
    assert (cfg.delta, cfg.min_area, cfg.max_area, cfg.max_variation) == (
        7,
        200,
        2000,
        0.15,
    )
    assert cfg.to_string() == "MSER_7_200_2000_0.15"
    assert MSERConfig.from_string("MSER_7_200_2000_1").to_string() == "MSER_7_200_2000_1"


@pytest.mark.parametrize(
    "spec",
    [
        "MSER_0_200_2000_0.5",  # delta out of range
        "MSER_41_200_2000_0.5",
        "MSER_7_0_2000_0.5",  # min_area out of range
        "MSER_7_3000_2000_0.5",  # min > max
        "MSER_7_200_2000_0",  # variation must be > 0
        "MSER_7_200_2000_1.5",  # variation must be <= 1
        "MSER_7_200_2000",  # wrong arity
        "FAST_7_200_2000_0.5",  # wrong name
        "MSER_x_200_2000_0.5",  # non-numeric
    ],
)
def test_mser_string_rejects(spec):
    with pytest.raises(ConfigError):
        MSERConfig.from_string(spec)


def test_classifier_string():
    cfg = ClassifierConfig.from_string("HOG_LDA_BAYES")
    assert cfg.classifier == "LDABAYES"
    assert ClassifierConfig.from_string("GRAY_LDA_KNN").features == "GRAY"
    with pytest.raises(ConfigError):
        ClassifierConfig.from_string("SIFT_LDA_KNN")
    with pytest.raises(ConfigError):
        ClassifierConfig.from_string("HOG_PCA_KNN")
    with pytest.raises(ConfigError):
        ClassifierConfig.from_string("HOG_LDA_SVM")
