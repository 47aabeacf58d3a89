// The deep-head designs of the attention kernels (#1 forward, #2 dq, #3
// dk/dv) at head depths 256 and 512, defined in attention_deep.cu and
// reached through the C entry points of attention_fwd.cu and
// attention_bwd.cu, whose dispatch sends these depths here. The kernels of
// depths up to 128 are not touched by them: each depth class has kernels of
// its own, chosen at compile time by the head dim, not by a runtime flag.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_deep {

// the head dims the deep designs take
constexpr bool takes(int head_dim) { return head_dim == 256 || head_dim == 512; }

// the arguments of the backward entry points, as attention_bwd.cu receives them
struct BwdArgs {
  const void *q, *k, *v, *g;
  const float *bias, *m, *l, *delta;
  void *dq, *dk, *dv;
  int batch, t_len, s_len, heads, causal, causal_offset;
  int64_t st[12];  // (batch, row, head) strides in elements of q, k, v, g
  cudaStream_t stream;
};

// dtype 0 (float32) runs the scalar design, 1 (bfloat16) the wgmma design;
// the arguments are those of the C entry point attention_fwd
cudaError_t fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                const float* bias, void* out, float* m_out, float* l_out, int batch, int t_len,
                int s_len, int heads, int causal, int causal_offset, const int64_t* sq,
                const int64_t* sk, const int64_t* sv, cudaStream_t stream);
cudaError_t bwd_dq(int dtype, int head_dim, const BwdArgs& a);
cudaError_t bwd_dkv(int dtype, int head_dim, const BwdArgs& a);

}  // namespace attn_deep
