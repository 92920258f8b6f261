// The multislice.cu kernels under the bfloat16 compute policy: every line
// transform rounds its operand to bfloat16 first (see multislice.cu). A file of
// its own, so that nvcc builds it beside the FP32 kernels in parallel and the
// FP32 file compiles as it did; its entry points are multislice.cu's with the
// suffix _bf16.

#define PTYRAD_BF16_OPERANDS 1
#include "multislice.cu"
