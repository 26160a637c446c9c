"""Op cast lists (copy of ``incubator_mxnet_tpu/amp/lists.py``; reference
contrib/amp/lists/symbol_fp16.py and symbol_bf16.py).

Three classes per target dtype:

* ``*_LP16`` — always run in the low-precision dtype (matrix products
  and convolutions: the FLOPs live here, and bf16/fp16 inputs run on the
  tensor cores).
* ``*_FP32`` — numerically sensitive, keep fp32 (exp/log-heavy math,
  loss ops; for fp16 also the norm layers, whose variance computation
  overflows fp16's 5-bit exponent).
* ``*_WIDEST`` — follow the widest floating input type (elementwise
  combiners where silently downcasting one side loses information).

Ops in no list run in whatever dtype their inputs already have.  The
bf16 lists leave the norm layers out: bf16 shares fp32's exponent range,
and the port's norm ops (``ops/nn_ops.py``) already take their
statistics in fp32 while the normalize runs in the activation dtype.

Names are the JAX package's op-registry names; ``amp.cast_args`` applies
the lists in each op function of the port.
"""

# ---- shared op families ---------------------------------------------------

_MATMUL_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "matmul", "linalg_gemm2", "RNN", "dot_product_attention",
]

_SENSITIVE_OPS = [
    "softmax", "log_softmax", "SoftmaxOutput", "softmax_cross_entropy",
    "norm", "mean", "sum", "exp", "log", "log2", "log10", "log1p",
    "erfinv", "power", "ctc_loss", "logsumexp", "var", "std", "cumsum",
    "SoftmaxActivation", "MakeLoss",
]

_NORM_OPS = [
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "RMSNorm",
    "L2Normalization",
]

_WIDEST_OPS = [
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "where",
    "concat", "stack", "elemwise_add", "elemwise_sub", "elemwise_mul",
    "elemwise_div", "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_div",
]

# ---- fp16 (reference lists/symbol_fp16.py) --------------------------------

FP16_LP16 = list(_MATMUL_OPS)
FP16_FP32 = list(_SENSITIVE_OPS) + list(_NORM_OPS)
FP16_WIDEST = list(_WIDEST_OPS)

# ---- bf16 (reference lists/symbol_bf16.py) --------------------------------

BF16_LP16 = list(_MATMUL_OPS)
BF16_FP32 = list(_SENSITIVE_OPS)
BF16_WIDEST = list(_WIDEST_OPS)


def get_lists(target_dtype):
    """(lp16, fp32, widest) op lists for a target low-precision dtype."""
    name = str(target_dtype)
    if "bfloat16" in name:
        return BF16_LP16, BF16_FP32, BF16_WIDEST
    return FP16_LP16, FP16_FP32, FP16_WIDEST
