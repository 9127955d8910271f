// Device time of the bf16 stem forward (csrc/stem_conv.cu:lfb_stem_conv_bf16)
// alone: back-to-back launches on seeded inputs, timed with CUDA events, with
// no PyTorch wrapper around them.  Build and run from the root of a checkout
// on a machine with an sm_90a card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/stem_conv_bench lfb_tpu_torch/csrc/bench/stem_conv_bench.cu
//   build/stem_conv_bench [B T H W kT]     (default 16 32 256 256 5)
//
// Prints the card and the best and mean of 10 launches after 3 warm-ups.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../stem_conv.cu"

int main(int argc, char** argv) {
  int B = 16, T = 32, H = 256, W = 256, kT = 5;
  if (argc == 6) {
    B = atoi(argv[1]);
    T = atoi(argv[2]);
    H = atoi(argv[3]);
    W = atoi(argv[4]);
    kT = atoi(argv[5]);
  }
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const size_t nx = (size_t)B * T * H * W * 3, nw = (size_t)kT * 16 * 1024;
  const size_t no = (size_t)B * T * Ho * Wo * 64;
  std::vector<__nv_bfloat16> hx(nx), hw(nw);
  for (size_t i = 0; i < nx; ++i)
    hx[i] = __float2bfloat16((float)((i * 2654435761u) % 1000) / 1000.f - 0.5f);
  for (size_t i = 0; i < nw; ++i)
    hw[i] = __float2bfloat16((float)((i * 40503u) % 1000) / 1e4f - 0.05f);
  void *x, *w, *o;
  cudaMalloc(&x, nx * 2);
  cudaMalloc(&w, nw * 2);
  cudaMalloc(&o, no * 2);
  cudaMemcpy(x, hx.data(), nx * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(w, hw.data(), nw * 2, cudaMemcpyHostToDevice);
  for (int i = 0; i < 3; ++i) {
    const int err = lfb_stem_conv_bf16(x, w, o, B, T, H, W, kT, nullptr);
    if (err) {
      printf("launch failed: cudaError_t %d\n", err);
      return 1;
    }
  }
  if (cudaDeviceSynchronize() != cudaSuccess) {
    printf("run failed: %s\n", cudaGetErrorString(cudaGetLastError()));
    return 1;
  }
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f, sum = 0.f;
  const int n = 10;
  for (int i = 0; i < n; ++i) {
    cudaEventRecord(a);
    lfb_stem_conv_bf16(x, w, o, B, T, H, W, kT, nullptr);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
    sum += ms;
  }
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s: stem_conv bf16 x (%d, %d, %d, %d, 3) kT %d: best %.4f ms, "
         "mean %.4f ms\n", prop.name, B, T, H, W, kT, best, sum / n);
  return 0;
}
