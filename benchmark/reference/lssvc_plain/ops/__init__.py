from .nn import (
    OD_OFFSET_CAP_SERVING,
    avg_pool2d,
    conv2d,
    conv_transpose2d,
    gdn,
    leaky_relu,
    max_pool2d,
    pad_nhwc,
    pixel_shuffle,
    relu,
    set_fp32_parity,
    ste_round,
)
from .warp import (
    bilinear_downsample2,
    bilinear_resize,
    bilinear_upsample2,
    clamp_flow,
    flow_warp_grouped,
    flow_warp_shift_sum,
    grouped_warp_plain,
    grouped_warp_shift_sum,
)
from .warp_kernels import flow_warp, flow_warp_pair, grouped_warp
