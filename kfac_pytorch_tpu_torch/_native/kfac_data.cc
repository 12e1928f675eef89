// Native data-pipeline kernel of the PyTorch port: fused gather +
// reflect-pad random crop + horizontal flip over a float32 NHWC image
// array, multithreaded.
//
// The per-step augmentation of the trainers' ArrayLoader
// (kfac_pytorch_tpu_torch/examples/cnn_utils/datasets.py) in one pass:
// no padded intermediate array, no per-image Python loop, so the host
// keeps the input pipeline off the training step's critical path.
//
// The randomness stays in Python (numpy Generator draws ys/xs/flips), so
// the native and numpy paths are bit-identical under the same draws,
// which tests/test_torch_native.py holds.
//
// Build (done at first use): g++ -O3 -shared -fPIC -std=c++17 -pthread
//   -o libkfac_data.so kfac_data.cc

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// numpy 'reflect' (no repeated edge): valid for |offset| < n.
inline int64_t reflect(int64_t i, int64_t n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

void worker(const float* images, const int64_t* idx, int64_t b_begin,
            int64_t b_end, int64_t h, int64_t w, int64_t c, int64_t pad,
            const int32_t* ys, const int32_t* xs, const uint8_t* flips,
            float* out) {
  const int64_t row = w * c;
  const int64_t img_sz = h * row;
  for (int64_t b = b_begin; b < b_end; ++b) {
    const float* src = images + idx[b] * img_sz;
    float* dst = out + b * img_sz;
    const int64_t y0 = ys[b] - pad;
    const int64_t x0 = xs[b] - pad;
    const bool flip = flips[b] != 0;
    for (int64_t y = 0; y < h; ++y) {
      const float* srow = src + reflect(y0 + y, h) * row;
      float* drow = dst + y * row;
      if (flip) {
        // out[y][x] = crop[y][w-1-x]; crop[y][x] = src[sy][reflect(x0+x)]
        for (int64_t x = 0; x < w; ++x) {
          const int64_t sx = reflect(x0 + (w - 1 - x), w);
          std::memcpy(drow + x * c, srow + sx * c, c * sizeof(float));
        }
      } else if (x0 == 0) {
        // Crop width equals source width, so the only reflection-free
        // x offset is 0 — whole-row memcpy.
        std::memcpy(drow, srow + x0 * c, row * sizeof(float));
      } else {
        for (int64_t x = 0; x < w; ++x) {
          const int64_t sx = reflect(x0 + x, w);
          std::memcpy(drow + x * c, srow + sx * c, c * sizeof(float));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// images: [n_total, h, w, c] f32; idx/ys/xs/flips: [batch]; out: [batch,
// h, w, c] f32.  pad is the reflect-padding margin (crop offsets ys/xs
// are drawn in [0, 2*pad]).
void kfac_gather_crop_flip(const float* images, const int64_t* idx,
                           int64_t batch, int64_t h, int64_t w, int64_t c,
                           int64_t pad, const int32_t* ys, const int32_t* xs,
                           const uint8_t* flips, float* out,
                           int64_t n_threads) {
  if (n_threads <= 1 || batch < 4) {
    worker(images, idx, 0, batch, h, w, c, pad, ys, xs, flips, out);
    return;
  }
  n_threads = std::min<int64_t>(n_threads, batch);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(batch, b0 + chunk);
    if (b0 >= b1) break;
    threads.emplace_back(worker, images, idx, b0, b1, h, w, c, pad, ys, xs,
                         flips, out);
  }
  for (auto& th : threads) th.join();
}

// Plain sharded gather (the non-augmented path): out[b] = images[idx[b]].
void kfac_gather(const float* images, const int64_t* idx, int64_t batch,
                 int64_t item_sz, float* out, int64_t n_threads) {
  auto gather_worker = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      std::memcpy(out + b * item_sz, images + idx[b] * item_sz,
                  item_sz * sizeof(float));
    }
  };
  if (n_threads <= 1 || batch < 4) {
    gather_worker(0, batch);
    return;
  }
  n_threads = std::min<int64_t>(n_threads, batch);
  std::vector<std::thread> threads;
  const int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(batch, b0 + chunk);
    if (b0 >= b1) break;
    threads.emplace_back(gather_worker, b0, b1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
