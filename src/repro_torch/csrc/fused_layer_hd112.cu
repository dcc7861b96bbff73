// The fused decode layer (fused_layer.cu) at head dim 112: its four
// variants (sim or off x f32 or int8 cache), compiled in a file of their own
// so that the build's parallel nvcc processes keep its wall time flat.
#include "fused_layer.cuh"

FUSED_LAYER_INSTANCE(112)
