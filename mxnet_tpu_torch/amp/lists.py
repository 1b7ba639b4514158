"""AMP op lists of the port: the reference's five lists
(``mxnet_tpu/amp/lists.py``), copied verbatim so that both packages cast
the same ops the same way.

``TARGET_DTYPE_OPS`` run in the target dtype (bf16 or fp16: products,
convolutions, attention, embeddings); ``FP32_OPS`` in float32 (the
exp/log families, norms, losses, reductions); ``CONDITIONAL_FP32_OPS`` in
float32 when an attribute takes one of the listed values;
``WIDEST_TYPE_CASTS`` and ``DTYPE_NEUTRAL_OPS`` are not cast. Some names
are ops the port has not registered yet (``SyncBatchNorm``, the image,
quantization and optimizer families of later slices);
``tests/test_torch_amp.py`` holds the set of them.
"""

# compute-bound ops that benefit from bf16 on the MXU
TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "RNN", "dot",
    "batch_dot", "matmul", "einsum", "khatri_rao", "linalg_gemm",
    "linalg_gemm2", "linalg_syrk", "linalg_trmm",
    "DeformableConvolution",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt", "multi_head_attention",
    "flash_attention", "single_query_attention", "Embedding",
    "_contrib_SparseEmbedding",
]

# numerically sensitive ops pinned to fp32
FP32_OPS = [
    "BatchNorm", "BatchNorm_v1", "SyncBatchNorm", "BatchNormWithReLU", "LayerNorm",
    "GroupNorm", "InstanceNorm", "L2Normalization", "LRN", "SoftmaxOutput",
    "softmax", "log_softmax", "masked_softmax", "softmin", "softmax_cross_entropy", "CTCLoss", "exp", "log", "log2",
    "log10", "log1p", "expm1", "sum", "mean", "prod", "nansum", "nanprod",
    "norm", "erf", "erfinv", "gamma", "gammaln", "digamma", "cumsum",
    "cumprod", "logsumexp", "linalg_potrf", "linalg_potri",
    "linalg_sumlogdiag", "linalg_trsm", "linalg_svd", "linalg_inverse",
    "linalg_det", "linalg_slogdet", "linalg_syevd", "linalg_gelqf",
    "moments", "mish", "smooth_l1", "_contrib_hawkes_ll", "_contrib_hawkesll",
    "LinearRegressionOutput", "LogisticRegressionOutput", "MAERegressionOutput",
    "MakeLoss", "make_loss", "SVMOutput", "Correlation",
    "RMSNorm", "SoftmaxActivation", "softrelu", "gelu_tanh", "erf_inv",
    "sum_axis", "_contrib_div_sqrt_dim",
    "rsqrt", "rcbrt", "reciprocal", "cosh", "sinh", "tanh",
    "arcsinh", "arccosh", "arctanh", "sigmoid", "hard_sigmoid", "softsign",
    "_contrib_fft", "_contrib_ifft", "_contrib_count_sketch", "col2im",
]

# conditionally fp32 (parity with symbol_fp16.py CONDITIONAL_FP32_FUNCS)
CONDITIONAL_FP32_OPS = [
    ("Activation", "act_type", ["softrelu"]),
    ("leaky_relu", "act_type", ["gelu"]),
]

# ops that take the widest dtype among inputs (safe in any float dtype)
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_mod", "broadcast_power", "broadcast_maximum",
    "broadcast_minimum", "broadcast_hypot", "hypot", "elemwise_add", "elemwise_sub",
    "elemwise_mul", "elemwise_div", "add_n", "concat", "stack", "where",
    "maximum", "minimum", "clip", "abs", "sign", "negative", "square",
    "sqrt", "cbrt", "floor", "ceil", "round", "rint", "trunc", "fix",
    "relu", "sin", "cos", "tan", "arcsin", "arccos", "arctan", "degrees",
    "radians", "gelu", "silu", "prelu", "Activation",
    "leaky_relu", "Pooling", "UpSampling", "Dropout", "reshape", "flatten", "transpose", "swapaxes", "expand_dims", "squeeze",
    "broadcast_to", "broadcast_axis", "broadcast_like", "reshape_like",
    "split", "split_v2", "slice", "slice_axis", "slice_like", "pad", "tile",
    "repeat", "reverse", "depth_to_space", "space_to_depth",
    "diag", "take", "batch_take", "take_along_axis", "pick", "gather_nd", "scatter_nd",
    "index_add", "index_copy", "slice_assign", "slice_assign_scalar",
    "sequence_mask", "sequence_last", "sequence_reverse",
    "boolean_mask_dense", "sort", "max", "min", "identity",
    "BlockGrad", "im2col", "_contrib_ROIAlign", "_contrib_RROIAlign", "ROIPooling",
    "BilinearResize2D", "AdaptiveAvgPooling2D", "GridGenerator", "BilinearSampler", "SpatialTransformer", "_contrib_gradientmultiplier", "IdentityAttachKLSparseReg",
    "_contrib_quadratic", "ldexp", "_div_scalar", "_hypot_scalar",
    "_maximum_scalar", "_minimum_scalar", "_minus_scalar", "_mod_scalar",
    "_mul_scalar", "_plus_scalar", "_power_scalar", "_scatter_set_nd",
    "arctan2", "linalg_extractdiag", "linalg_extracttrian",
    "linalg_makediag", "linalg_maketrian", "_contrib_index_copy",
]

# untouched by AMP: integer/bool/index outputs, shape metadata, RNG,
# optimizer updates (run outside the autocast region), quantization,
# detection post-processing, graph/debug utilities
DTYPE_NEUTRAL_OPS = [
    "cast", "amp_cast", "amp_multicast", "zeros_like", "ones_like",
    "shape_array",
    "size_array", "argmax", "argmin", "argsort", "topk", "unique",
    "one_hot", "histogram", "ravel_multi_index", "unravel_index",
    "arange_like", "logical_not",
    "isnan", "isinf", "isfinite", "all_finite", "multi_all_finite",
    "multi_sum_sq", "reset_arrays", "allclose", "bipartite_matching",
    "edge_id", "dgl_adjacency", "dgl_subgraph", "dgl_graph_compact",
    "dgl_csr_neighbor_uniform_sample",
    "dgl_csr_neighbor_non_uniform_sample", "_contrib_index_array",
    "_contrib_getnnz", "_contrib_box_iou", "_contrib_box_nms",
    "_contrib_box_encode", "_contrib_box_decode", "MultiBoxPrior",
    "MultiBoxTarget", "MultiBoxDetection", "Proposal", "argmax_channel",
    "broadcast_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor", "broadcast_not_equal",
    "_contrib_calibrate_entropy", "_contrib_quantize_v2",
    "_contrib_dequantize", "_contrib_requantize", "_contrib_quantized_conv",
    "_contrib_quantized_fully_connected", "_contrib_quantized_pooling",
    "_contrib_quantized_act", "_contrib_quantized_flatten",
    "_contrib_quantized_concat", "_contrib_quantized_elemwise_add",
    # int8-code ops (round 3 family completion): quantized codes are not
    # float activations, AMP must not touch them
    "_contrib_quantize", "_contrib_quantized_batch_norm",
    "_contrib_quantized_elemwise_mul", "_contrib_quantized_embedding",
    # boolean / target-generation outputs
    "_npx_constraint_check", "_contrib_mrcnn_mask_target",
    # straight-through estimators: pass-through codes, dtype-preserving
    "_contrib_round_ste", "_contrib_sign_ste",
    # host-boundary image augmentation pipeline ops (uint8/float pixel
    # space, never inside an autocast training graph)
    "_image_to_tensor", "_image_normalize", "_image_resize", "_image_crop",
    "_image_flip_left_right", "_image_flip_top_bottom",
    "_image_random_flip_left_right", "_image_random_flip_top_bottom",
    "_image_random_brightness", "_image_random_contrast",
    "_image_random_saturation", "_image_random_hue",
    "_image_random_color_jitter", "_image_adjust_lighting",
    "_image_random_lighting",
]

FP16_FUNCS = TARGET_DTYPE_OPS          # compat aliases (reference naming)
FP16_FP32_FUNCS = WIDEST_TYPE_CASTS
FP32_FUNCS = FP32_OPS
BF16_FUNCS = TARGET_DTYPE_OPS
