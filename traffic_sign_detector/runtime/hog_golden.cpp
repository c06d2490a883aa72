// cv2-HOG golden-fixture generator against the SYSTEM OpenCV 4.6 C++ API.
//
// The container's python cv2 is 5.0, which removed HOGDescriptor, so the
// reference's descriptor call (`Reconocimiento de Objetos/source.py:490-491`)
// could not be oracled from python.  The system
// image does ship OpenCV 4.6 C++ dev libraries — the same 4.x lineage the
// reference ran — so this tool computes the true cv::HOGDescriptor output
// for the fixture crops:
//
//   stdin:  int32 n, then n * 32*32 uint8 grayscale crops
//   stdout: n * 324 float32 descriptors
//
// HOG configuration = the reference's exactly (REC/constants.py:14):
// win 32x32, block 16x16, stride 8x8, cell 8x8, 9 bins, signed gradients;
// everything else at OpenCV defaults (L2Hys 0.2, no gamma, derivAperture 1).
//
// Build + run: scripts/make_cv2_hog_fixture.py --native

#include <cstdint>
#include <cstdio>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/objdetect.hpp>

int main() {
  int32_t n = 0;
  if (std::fread(&n, sizeof(n), 1, stdin) != 1 || n <= 0 || n > 4096) {
    std::fprintf(stderr, "bad crop count\n");
    return 1;
  }
  cv::HOGDescriptor hog(
      cv::Size(32, 32), cv::Size(16, 16), cv::Size(8, 8), cv::Size(8, 8), 9,
      /*derivAperture=*/1, /*winSigma=*/-1,
      cv::HOGDescriptor::L2Hys, /*L2HysThreshold=*/0.2,
      /*gammaCorrection=*/false, /*nlevels=*/cv::HOGDescriptor::DEFAULT_NLEVELS,
      /*signedGradient=*/true);
  std::vector<uint8_t> buf(32 * 32);
  std::vector<float> desc;
  for (int i = 0; i < n; ++i) {
    if (std::fread(buf.data(), 1, buf.size(), stdin) != buf.size()) {
      std::fprintf(stderr, "short read at crop %d\n", i);
      return 1;
    }
    cv::Mat img(32, 32, CV_8UC1, buf.data());
    hog.compute(img, desc);
    if (desc.size() != 324) {
      std::fprintf(stderr, "unexpected descriptor size %zu\n", desc.size());
      return 1;
    }
    std::fwrite(desc.data(), sizeof(float), desc.size(), stdout);
  }
  return 0;
}
