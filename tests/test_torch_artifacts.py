"""The CLI's artifact dumps (`--save_decoded_frame`, `--save_decoded_mv`,
`--save_warp_frame`, `--save_decoded_context`): the port's flow
colouring against the JAX package's, its PNG writer's bytes read back
with `zlib` alone (so this runs whether or not PIL is installed), and the
CLI on the CPU writing the JAX package's file tree with the JAX package's
pixel rules.  The CLI case codes a synthetic 128x128 sequence, 3 frames
(I P P), x2, fp32, estimated bits, from `.pth` checkpoints of the JAX
package's `init_intra_ss(192)` and `init_lssvc(0)` bridged by
`params_from_jax`.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from lssvc_tpu.utils.flow_vis import flow_to_image as j_flow_to_image
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.harness import runner as trunner
from lssvc_tpu_torch.tools.synthetic import write_dataset
from lssvc_tpu_torch.utils.flow_vis import flow_to_image
from lssvc_tpu_torch.utils.png import encode_png, read_png

from torch_threads import share_cores

share_cores()

FRAMES = 3


@pytest.mark.parametrize("scale", [0.3, 5.0, 80.0])
def test_flow_to_image_equals_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    flow = (rng.standard_normal((37, 53, 2)) * scale).astype(np.float32)
    flow[0, 0] = 0.0  # a zero vector, and the row wrap of the colour wheel
    got = flow_to_image(flow)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, j_flow_to_image(flow))


def _parse(data: bytes):
    """A PNG's chunks by hand: (IHDR fields, the inflated rows)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc, tag
        chunks.append((tag, body))
        pos += 12 + length
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    return (struct.unpack(">IIBBBBB", chunks[0][1]),
            zlib.decompress(chunks[1][1]))


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3)])
def test_png_writer_bytes(shape):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    header, raw = _parse(encode_png(img))
    channels = 1 if len(shape) == 2 else 3
    assert header == (shape[1], shape[0], 8, 0 if channels == 1 else 2, 0, 0,
                      0)
    rows = np.frombuffer(raw, np.uint8).reshape(shape[0],
                                                1 + shape[1] * channels)
    assert not rows[:, 0].any()  # filter 0 on every row
    np.testing.assert_array_equal(rows[:, 1:].reshape(img.shape), img)


def test_cli_writes_the_jax_file_tree(tmp_path, monkeypatch):
    """All four flags: `<path>_IntraNoAR_LSSVC/seq1/0/x2/{BL,EL}/<i>.png`
    for every frame, and `.../x2/<i>.png` of the motion, the warped frame
    and the context for the P-frames, as the JAX package lays them out;
    the decoded pictures' pixels are rint(255 x) of the run's pictures,
    the motion's the JAX colouring of the run's EL motion, the warped
    frame's and the context's the JAX rules on the run's arrays."""
    cfg = write_dataset(tmp_path / "ds", 128, 128, frames=FRAMES, gop=FRAMES,
                        seed=4)
    intra, video = tmp_path / "intra.pth", tmp_path / "video.pth"
    for path, params, kind in ((intra, j_init_intra_ss(192), "intra_ss"),
                               (video, j_init_lssvc(0), "lssvc")):
        torch.save(params_from_jax({k: np.asarray(v)
                                    for k, v in params.items()}, kind), path)
    seen = []
    real_copy = trunner.HostCopy

    def recording(tensors):
        copy = real_copy(tensors)
        seen.append(copy)
        return copy

    monkeypatch.setattr(trunner, "HostCopy", recording)
    base = {a: tmp_path / a for a in trunner.ARTIFACTS}
    cli.main(["--test_config", str(cfg), "--i_frame_model_path", str(intra),
              "--model_path", str(video), "--output_path",
              str(tmp_path / "out"), "--ratios", "x2", "--device", "cpu"]
             + [arg for a in trunner.ARTIFACTS
                for arg in (f"--save_{a}", "1", f"--{a}_path", str(base[a]))])

    roots = {a: tmp_path / f"{a}_IntraNoAR_LSSVC" / "seq1" / "0" / "x2"
             for a in trunner.ARTIFACTS}
    want = {roots["decoded_frame"] / layer / f"{i}.png"
            for layer in ("BL", "EL") for i in range(FRAMES)}
    want |= {roots[a] / f"{i}.png" for a in trunner.ARTIFACTS[1:]
             for i in range(1, FRAMES)}
    assert {p for p in tmp_path.rglob("*.png")} == want

    def rint(a):
        return np.clip(np.rint(a * 255), 0, 255).astype(np.uint8)

    for i, copy in enumerate(seen):
        out = copy.get()
        for layer in ("BL", "EL"):
            np.testing.assert_array_equal(
                read_png(roots["decoded_frame"] / layer / f"{i}.png"),
                rint(out[f"x_hat_{layer.lower()}"].transpose(1, 2, 0)))
        if i == 0:
            assert not {"mv", "warp_frame", "context"} & set(out)
            continue
        np.testing.assert_array_equal(
            read_png(roots["decoded_mv"] / f"{i}.png"),
            j_flow_to_image(out["mv"]))
        np.testing.assert_array_equal(
            read_png(roots["warp_frame"] / f"{i}.png"),
            rint(out["warp_frame"].transpose(1, 2, 0)))
        ctx = out["context"]  # `lssvc_tpu/harness/runner.py:285-289`
        lo, hi = float(ctx.min()), float(ctx.max())
        assert hi > lo
        np.testing.assert_array_equal(
            read_png(roots["decoded_context"] / f"{i}.png"),
            rint((ctx - lo) / (hi - lo)))
