"""Spatial padding for single- and two-layer coding (a copy of the JAX
package's `utils/padding.py`; plain Python).

The reference's padding rules (`src/utils/common.py:15-90`): frames are
padded on the right and bottom so that the enhancement-layer size is
divisible by both 64 and 64*ratio, which makes the derived base-layer size
divisible by 64 and gives every stride-2 stage of the autoencoders even
sizes.
"""

from __future__ import annotations


def get_padding_size(height: int, width: int, p: int = 64):
    """Right/bottom padding that rounds (height, width) up to multiples of p.

    Returns (left, right, top, bottom) — torch.nn.functional.pad order.
    """
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    padding_left = 0
    padding_right = int(new_w - width - padding_left)
    padding_top = 0
    padding_bottom = int(new_h - height - padding_top)
    return padding_left, padding_right, padding_top, padding_bottom


def round_to_even(x) -> int:
    tmp = int(x)
    return tmp + 1 if tmp % 2 != 0 else tmp


def get_interlayer_padding(H_HR: int, W_HR: int, ratio: float) -> dict:
    """Find the smallest padded EL size divisible by 64 and by 64*ratio.

    The search widens the rounding granule p = 64, 96, 128, ... until the
    rounded size satisfies both divisibility constraints (reference
    `common.py:48-86`). The BL size is the EL size divided by `ratio`
    (rounded to even for the unpadded frame, exact for the padded frame).
    """
    i = 0
    while True:
        p = 64 + 32 * i
        tmp_H = (H_HR + p - 1) // p * p
        if tmp_H % 64 == 0 and tmp_H % (64 * ratio) == 0:
            new_H_HR = tmp_H
            break
        i += 1
    i = 0
    while True:
        p = 64 + 32 * i
        tmp_W = (W_HR + p - 1) // p * p
        if tmp_W % 64 == 0 and tmp_W % (64 * ratio) == 0:
            new_W_HR = tmp_W
            break
        i += 1

    padding_left_EL = 0
    padding_right_EL = new_W_HR - W_HR - padding_left_EL
    padding_top_EL = 0
    padding_bottom_EL = new_H_HR - H_HR - padding_top_EL

    H_LR = round_to_even(H_HR / ratio)
    W_LR = round_to_even(W_HR / ratio)

    new_H_LR = int(new_H_HR / ratio)
    new_W_LR = int(new_W_HR / ratio)

    padding_LR = (0, new_W_LR - W_LR, 0, new_H_LR - H_LR)
    padding_HR = (padding_left_EL, padding_right_EL, padding_top_EL, padding_bottom_EL)

    return {
        "P_LR": padding_LR,
        "P_HR": padding_HR,
        "LR_padded_size": (new_H_LR, new_W_LR),
        "HR_padded_size": (new_H_HR, new_W_HR),
        "LR_size": (H_LR, W_LR),
        "HR_size": (H_HR, W_HR),
    }


def inverse_padding_size(p_size: tuple) -> tuple:
    """Negate a (l, r, t, b) pad spec, turning a pad into a crop."""
    return (-p_size[0], -p_size[1], -p_size[2], -p_size[3])
