// K3 (edge_map_bwd_tc.cu) for the stacks that apply selu, gelu, sigmoid or
// tanh: the same source, built with its kernels for every activation code
// of the layer table (edge_stack.cuh ActCode) in a library of its own, so
// that it compiles beside the kernels for codes 0-3 and not after them.
// ops/edge_map.py sends a stack here where edge_stack.cuh stack_codes gives
// kActCodes.

#define GCP_K3_EVERY_CODE
#include "edge_map_bwd_tc.cu"
