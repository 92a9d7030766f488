// One ideal Weiszfeld step (the gm2 aggregator) over a [K, d] client stack.
//
// Replaces the TPU kernel byzantine_aircomp_tpu/ops/pallas_kernels.py
// weiszfeld_step / _weiszfeld_kernel (:98-153):
//   inv_i = 1 / max(||w_i - g||, 1e-4), 0 for a row with a non-finite entry
//   num   = sum_i inv_i * w_i   [d] f32
//   den   = sum_i inv_i         []  f32
// w is f32 or bf16 (read as bf16, computed in f32); g, num, den are f32.
// weiszfeld_step_fused also takes the Weiszfeld loop's guess update,
// g_next = num / den with the stopping rule, into the same launch.
//
// Bound: K*d*bytes(dtype) read once, plus 2*d*4 bytes for g and num (or
// g_out), at the H100's 3.35 TB/s: 9.4 us at K=1000, d=7850, f32.  The TPU
// kernel carried num/den across a sequential grid; here one cooperative
// launch tiles the stack over every SM and meets at grid barriers, reading
// the stack once and summing in fixed orders (weiszfeld_common.cuh); past
// SMs x 8192 columns (the CNN, ResNet-18) it reads the stack twice, the
// least traffic where the stack cannot stay on chip.
//
// weiszfeld_loop_condition is the stopping test of a Weiszfeld loop that a
// CUDA graph runs as a conditional node (ops/aggregators.py): one thread,
// launched last in each run of the node's body of fused steps.
#include "weiszfeld_common.cuh"

namespace weiszfeld {

// Counts the body's `chunk` step launches into *launched; where set & 1
// (the body of a WHILE node), goes on with another chunk only while the
// solve is active and the chunk fits under maxiter (while the solve is
// active every step so far was live, so *steps is the steps launched);
// where set & 2, lets the tail's IF node run only while the solve is
// active.
__global__ void loop_condition_kernel(const int* active, const long long* steps,
                                      long long* launched, int chunk, long long maxiter,
                                      int set, cudaGraphConditionalHandle loop,
                                      cudaGraphConditionalHandle tail) {
  *launched += chunk;
  const bool on = *active != 0;
  if (set & 1) cudaGraphSetConditional(loop, on && *steps + chunk <= maxiter ? 1u : 0u);
  if (set & 2) cudaGraphSetConditional(tail, on ? 1u : 0u);
}

}  // namespace weiszfeld

// num/den mode.  workspace: weiszfeld_workspace_bytes(k, d) bytes, ticket
// zeroed.
extern "C" int weiszfeld_step_launch(const void* w, int w_is_bf16,
                                     const float* g, long long k, long long d,
                                     void* workspace, float* num, float* den,
                                     void* stream) {
  weiszfeld::Params p = {};
  p.w = w;
  p.k = k;
  p.d = d;
  p.g_in = g;
  p.num = num;
  p.den = den;
  return static_cast<int>(weiszfeld::launch<false, false>(
      p, w_is_bf16, workspace, static_cast<cudaStream_t>(stream)));
}

// fused mode: g_out <- the step's guess (g_in when *active == 0), then
// steps += active and active &= ||g_in - g_next|| > tol.
extern "C" int weiszfeld_step_fused(const void* w, int w_is_bf16,
                                    const float* g_in, float* g_out,
                                    long long k, long long d, float tol,
                                    int* active, long long* steps,
                                    void* workspace, void* stream) {
  weiszfeld::Params p = {};
  p.w = w;
  p.k = k;
  p.d = d;
  p.g_in = g_in;
  p.g_out = g_out;
  p.tol = tol;
  p.active = active;
  p.steps = steps;
  return static_cast<int>(weiszfeld::launch<false, true>(
      p, w_is_bf16, workspace, static_cast<cudaStream_t>(stream)));
}

// The stopping test after a conditional body of `chunk` fused steps (see
// loop_condition_kernel); `loop` and `tail` are cudaGraphConditionalHandle
// values, read where `set` says.
extern "C" int weiszfeld_loop_condition(const int* active, const long long* steps,
                                        long long* launched, int chunk, long long maxiter,
                                        int set, unsigned long long loop,
                                        unsigned long long tail, void* stream) {
  weiszfeld::loop_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      active, steps, launched, chunk, maxiter, set, loop, tail);
  return static_cast<int>(cudaGetLastError());
}
