// The kernels of dcn_fused.cu with one part cut out, for the split of
// `python -m bevformer_tensorrt_tpu_torch.tools.kernel_bench --parts
// dcn_split`: cut 1 leaves out the corner loads (the sampled tiles blend
// zeros), cut 2 the product.  Built on demand by that tool alone.
#define DCN_SPLIT 1
#include "dcn_fused.cu"
