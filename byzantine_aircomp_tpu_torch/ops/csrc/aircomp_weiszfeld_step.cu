// One over-the-air Weiszfeld step (the gm aggregator) over a [K, d] stack.
//
// Replaces the TPU kernel byzantine_aircomp_tpu/ops/pallas_kernels.py
// aircomp_weiszfeld_step / _aircomp_kernel (:160-246): the same distances as
// the ideal step plus ||w_i||^2, then OMA2's truncated channel inversion on
// the message m_i = [w_i * inv_i, s * inv_i] of width d + 1:
//   p_i    = inv_i^2 (||w_i||^2 + s^2) / (d + 1) / h_sq_i
//   gain_i = sqrt(p_max / max(p_i, 500 s^2))
//   num    = sum_i gain_i * inv_i * w_i      [d] f32
//   den    = s * sum_i gain_i * inv_i        []  f32
// Rows with a non-finite entry transmit nothing.  The scaler s is read from
// device memory, so the Weiszfeld loop never waits on the host for it.
//
// aircomp_weiszfeld_step_fused takes the whole step of the gm loop: it
// forms h_sq from the fade draws (h = fade_scale * draw, |h|^2 floored at
// 1e-6, rounded as channel.rayleigh_fade and channel.floored_hsq round),
// adds the receiver noise n = noise_scale * z to num and den, sets
// g_next = (num + n[:d]) / (den + n[d]) * s with each op rounded as torch
// rounds it, applies the stopping rule, and writes the next step's scaler
// sqrt(mean(g_out^2)).  The draws themselves stay in torch.
//
// Bound: K*d*bytes(dtype) read once, plus g, z, g_out (3*d*4 bytes) and the
// fades (2*K*4), at the H100's 3.35 TB/s: 0.5 us at K=50, d=7850, f32;
// past SMs x 8192 columns the stack is read twice (the wide plan).
// Design and determinism as in weiszfeld_common.cuh.
#include "weiszfeld_common.cuh"

// num/den mode, h_sq given.  workspace as for weiszfeld_step_launch.
extern "C" int aircomp_weiszfeld_step_launch(
    const void* w, int w_is_bf16, const float* g, const float* h_sq,
    float* scaler, float p_max, long long k, long long d, void* workspace,
    float* num, float* den, void* stream) {
  weiszfeld::Params p = {};
  p.w = w;
  p.k = k;
  p.d = d;
  p.g_in = g;
  p.h_sq = h_sq;
  p.scaler = scaler;
  p.p_max = p_max;
  p.num = num;
  p.den = den;
  return static_cast<int>(weiszfeld::launch<true, false>(
      p, w_is_bf16, workspace, static_cast<cudaStream_t>(stream)));
}

// fused mode.  h_r, h_i [K]: the fades divided by fade_scale (the raw
// normal draws with fade_scale = 1/sqrt(2), or given fades with 1); z
// [d+1] or null for a noiseless receiver; scaler [1] is updated in place.
extern "C" int aircomp_weiszfeld_step_fused(
    const void* w, int w_is_bf16, const float* g_in, float* g_out,
    const float* h_r, const float* h_i, float fade_scale, const float* z,
    float noise_scale, float* scaler, float p_max, long long k, long long d,
    float tol, int* active, long long* steps, void* workspace, void* stream) {
  weiszfeld::Params p = {};
  p.w = w;
  p.k = k;
  p.d = d;
  p.g_in = g_in;
  p.g_out = g_out;
  p.h_r = h_r;
  p.h_i = h_i;
  p.fade_scale = fade_scale;
  p.z = z;
  p.noise_scale = noise_scale;
  p.scaler = scaler;
  p.p_max = p_max;
  p.tol = tol;
  p.active = active;
  p.steps = steps;
  return static_cast<int>(weiszfeld::launch<true, true>(
      p, w_is_bf16, workspace, static_cast<cudaStream_t>(stream)));
}
