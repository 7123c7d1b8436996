"""The port's spatial mode (`lssvc_tpu_torch/parallel/spatial.py`,
`ops/strips.py`) on 2 and 4 gloo ranks against the JAX package.

The halo-exchange warps (`flow_warp_spatial`, `grouped_warp_spatial` and
both `*_sharded_auto`, the over-halo exact branch and the too-short-strip
refusal) against the JAX package's same functions on
`make_spatial_mesh(2)` / `(4)`, at `tests/test_spatial.py`'s shapes and
tolerances (rtol 1e-4, atol 5e-5; 1e-4 where the +halo row offset can flip
a bilinear tap).  The H-strip P-frame forward at EL 128 / BL 64 on 2 and 4
ranks with a chained second frame, and at x1.5 (EL 192 / BL 128), against
the JAX package's unsharded `forward_one_frame` on the same weights
(`convert.params_from_jax`): the DPB within rtol = atol = 1e-3, frame 2's
EL picture within 5e-3 of its max, bits within 1e-3 relative
(`tests/test_spatial.py:240-280`); also against the port's own unsharded
forward.  The IntraSS I-frame on strips against the JAX package's.

Each world size starts its ranks once (`tests/torch_dist.py`) and runs
every case; the JAX side runs here, in the test process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist
from lssvc_tpu.models import intra_ss as j_intra
from lssvc_tpu.models import lssvc as jl
from lssvc_tpu.models.init import init_intra_ss as j_init_intra_ss
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.parallel import spatial as jsp
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.harness.calibrate import calibrate_video
from lssvc_tpu_torch.models import intra_ss as t_intra
from lssvc_tpu_torch.models import lssvc as tl

from torch_threads import share_cores

share_cores()

DPB_KEYS = torch_dist.DPB_KEYS
BL_PREFIX = "base_layer_model."


def _np(a):
    return np.asarray(a)


def _warp_case(rng, h=64, w=32, c=5, fy_max=3.5, fx_max=9.0):
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    flow = np.stack([rng.uniform(-fx_max, fx_max, (1, h, w)),
                     rng.uniform(-fy_max, fy_max, (1, h, w))],
                    axis=-1).astype(np.float32)
    return x, flow


def _grouped_case(rng, h=64, fy_max=3.5, cg=3, w=32, edges=False):
    b, g, go = 1, 4, 8
    x = rng.standard_normal((b, h, w, g * cg)).astype(np.float32)
    fx = rng.uniform(-9, 9, (b, h, w, go)).astype(np.float32)
    fy = rng.uniform(-fy_max, fy_max, (b, h, w, go)).astype(np.float32)
    if edges:  # off-image flows at the global borders: the clamp path
        fy[:, :2] = -3.9
        fy[:, h - 2:] = 3.9
    mask = rng.uniform(0, 1, (b, h, w, go)).astype(np.float32)
    return x, fx, fy, mask, g


def _warp_cases(world):
    """(id, port call, JAX reference, atol) of the halo-warp cases at
    `world` ranks: at 2 ranks the guarded `*_sharded_auto` wrappers (both
    branches, the fmax bound, the serving halo 44 on strips taller than
    it), at 4 the single-hop wrappers, the halo deeper than a strip and
    the refusals."""
    rng = np.random.default_rng(world)
    mesh = jsp.make_spatial_mesh(world)
    j = jnp.asarray
    cases = []
    x, flow = _warp_case(rng)
    gx, gfx, gfy, gm, g = _grouped_case(rng, edges=True)
    if world == 2:
        cases.append(("flow_auto", ("flow_warp_sharded_auto", {"halo": 4},
                                    [x, flow]),
                      jsp.flow_warp_sharded_auto(j(x), j(flow), mesh,
                                                 halo=4), 5e-5))
        cases.append(("flow_auto_fmax", (
            "flow_warp_sharded_auto", {"halo": 4, "fmax": 3.6}, [x, flow]),
            jsp.flow_warp_sharded_auto(j(x), j(flow), mesh, halo=4,
                                       fmax=jnp.float32(3.6)), 5e-5))
        cases.append(("grouped_auto", (
            "grouped_warp_sharded_auto", {"group_num": g, "halo": 4},
            [gx, gfx, gfy, gm]),
            jsp.grouped_warp_sharded_auto(j(gx), j(gfx), j(gfy), j(gm), g,
                                          mesh, halo=4), 5e-5))
        # the serving halo 44 on strips taller than it, |flow_y| up to 40
        ex, efx, efy, em, g4 = _grouped_case(rng, h=512, fy_max=40.0, cg=2,
                                             w=16)
        cases.append(("grouped_auto_halo44", (
            "grouped_warp_sharded_auto", {"group_num": g4, "halo": 44},
            [ex, efx, efy, em]),
            jsp.grouped_warp_sharded_auto(j(ex), j(efx), j(efy), j(em), g4,
                                          mesh, halo=44), 1e-4))
        # |flow_y| past the halo: the exact branch
        xo, fo = _warp_case(rng, fy_max=20.0)
        cases.append(("flow_auto_over_halo", (
            "flow_warp_sharded_auto", {"halo": 4}, [xo, fo]),
            jsp.flow_warp_sharded_auto(j(xo), j(fo), mesh, halo=4), 5e-5))
        cases.append(("flow_auto_over_halo_fmax", (
            "flow_warp_sharded_auto", {"halo": 4, "fmax": 20.0}, [xo, fo]),
            jsp.flow_warp_sharded_auto(j(xo), j(fo), mesh, halo=4,
                                       fmax=jnp.float32(20.0)), 5e-5))
        ox, ofx, ofy, om, g = _grouped_case(rng, fy_max=25.0)
        cases.append(("grouped_auto_over_halo", (
            "grouped_warp_sharded_auto", {"group_num": g, "halo": 4},
            [ox, ofx, ofy, om]),
            jsp.grouped_warp_sharded_auto(j(ox), j(ofx), j(ofy), j(om), g,
                                          mesh, halo=4), 5e-5))
        return cases
    cases.append(("flow_spatial", ("flow_warp_spatial", {"halo": 4},
                                   [x, flow]),
                  jsp.flow_warp_spatial(j(x), j(flow), mesh, halo=4),
                  5e-5))
    xb, fb = _warp_case(rng)
    fb[:, :2, :, 1] = -3.9  # past the frame's top and bottom
    fb[:, -2:, :, 1] = 3.9
    cases.append(("flow_spatial_borders", ("flow_warp_spatial",
                                           {"halo": 4}, [xb, fb]),
                  jsp.flow_warp_spatial(j(xb), j(fb), mesh, halo=4), 5e-5))
    xw, fw = _warp_case(rng, h=32, w=48, fx_max=30.0)
    cases.append(("flow_spatial_wide", ("flow_warp_spatial", {"halo": 6},
                                        [xw, fw]),
                  jsp.flow_warp_spatial(j(xw), j(fw), mesh, halo=6), 5e-5))
    cases.append(("grouped_spatial", ("grouped_warp_spatial",
                                      {"group_num": g, "halo": 4},
                                      [gx, gfx, gfy, gm]),
                  jsp.grouped_warp_spatial(j(gx), j(gfx), j(gfy), j(gm), g,
                                           mesh, halo=4), 5e-5))
    # a halo deeper than the 16-row strips: the whole level gathered
    cases.append(("flow_auto_deep_halo", ("flow_warp_sharded_auto",
                                          {"halo": 20}, [x, flow]),
                  jsp.flow_warp_sharded_auto(j(x), j(flow), mesh, halo=20),
                  5e-5))
    cases.append(("grouped_auto_deep_halo", (
        "grouped_warp_sharded_auto", {"group_num": g, "halo": 20},
        [gx, gfx, gfy, gm]),
        jsp.grouped_warp_sharded_auto(j(gx), j(gfx), j(gfy), j(gm), g, mesh,
                                      halo=20), 5e-5))
    # a strip shorter than the halo: the single-hop wrappers refuse
    with pytest.raises(ValueError) as err:
        jsp.flow_warp_spatial(j(x), j(flow), mesh, halo=17)
    cases.append(("flow_spatial_refuses", ("flow_warp_spatial",
                                           {"halo": 17}, [x, flow]),
                  str(err.value), None))
    with pytest.raises(ValueError) as err:
        jsp.grouped_warp_spatial(j(gx), j(gfx), j(gfy), j(gm), g, mesh,
                                 halo=17)
    cases.append(("grouped_spatial_refuses", (
        "grouped_warp_spatial", {"group_num": g, "halo": 17},
        [gx, gfx, gfy, gm]), str(err.value), None))
    return cases


WARP_IDS = {2: ["flow_auto", "flow_auto_fmax", "grouped_auto",
                "grouped_auto_halo44", "flow_auto_over_halo",
                "flow_auto_over_halo_fmax", "grouped_auto_over_halo"],
            4: ["flow_spatial", "flow_spatial_borders", "flow_spatial_wide",
                "grouped_spatial", "flow_auto_deep_halo",
                "grouped_auto_deep_halo", "flow_spatial_refuses",
                "grouped_spatial_refuses"]}
# the branch each sharded-auto case must take
BRANCH = {"flow_auto": "strip", "flow_auto_fmax": "strip",
          "grouped_auto": "strip", "grouped_auto_halo44": "strip",
          "flow_auto_over_halo": "exact", "flow_auto_over_halo_fmax": "exact",
          "grouped_auto_over_halo": "exact", "flow_auto_deep_halo": "strip",
          "grouped_auto_deep_halo": "strip"}


def _check_warp(world, cases, results, case):
    i = WARP_IDS[world].index(case)
    _, (name, _, _), ref, atol = cases[i]
    got = [r[i] for r in results]
    if atol is None:  # the refusal, with the JAX package's message
        assert all(g == {"error": ref} for g in got), (got, ref)
        return
    out = torch.cat([g["out"] for g in got], dim=1).numpy()
    np.testing.assert_allclose(out, _np(ref), rtol=1e-4, atol=atol)
    if case in BRANCH:
        which = "grouped_warp" if "grouped" in name else "flow_warp"
        for g in got:
            counts = g["counts"][which]
            assert counts[BRANCH[case]] == 1 and sum(counts.values()) == 1, \
                counts


# ---------------------------------------------------------------------------
# the H-strip P-frame and I-frame forwards


@pytest.fixture(scope="module")
def lssvc_params():
    jparams = j_init_lssvc(0)
    tparams = params_from_jax({k: _np(v) for k, v in jparams.items()},
                              "lssvc")
    return jparams, {k: v.numpy() for k, v in tparams.items()}


def _frame_inputs(el_hw, bl_hw, seed):
    """The JAX test's inputs (`tests/test_spatial.py:225-235`)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    x_bl = _np(jax.random.uniform(ks[0], (1, *bl_hw, 3)))
    x_el = _np(jax.random.uniform(ks[1], (1, *el_hw, 3)))
    dpb = {"ref_frame_bl": jax.random.uniform(ks[2], (1, *bl_hw, 3)),
           "ref_frame_el": jax.random.uniform(ks[3], (1, *el_hw, 3)),
           "ref_feature_bl": jax.random.uniform(ks[4], (1, *bl_hw, 64)),
           "ref_feature_el": jax.random.uniform(ks[5], (1, *el_hw, 48))}
    return x_bl, x_el, {k: _np(v) for k, v in dpb.items()}


# (EL, BL, scale, frames chained); halos as the JAX test's (16, grouped 44)
GEOMETRY = {"x2": ((128, 128), (64, 64), 2.0, 2),
            "x1.5": ((192, 192), (128, 128), 1.5, 1)}
# frame heights for the ops' strip forms: strips of 12 and 9 rows on 2
# ranks (the second starting at an odd row), of 6 and 9 rows on 4
STRIP_HEIGHTS = {2: (24, 18), 4: (24, 36)}
STRIP_OPS = ("conv3x3", "conv3x3_s2", "conv7x7",
             "conv1x1_s2_pad0", "depthwise3x3", "deconv_s2", "deconv_s1",
             "avg_pool", "max_pool", "pixel_shuffle", "upsample2",
             "downsample2", "resize_x1.5", "pad_top_bottom", "clamp_flow",
             "int8_conv3x3_s2")
# the other modes of the models on 2 ranks (an int8 table calibrated at
# 128x128 on the CPU)
MODES = {"fp32_packed_ctx": dict(precision="fp32", packed_width=2,
                                 packed_ctx=True),
         "bf16_packed_ctx": dict(precision="bf16", packed_width=2,
                                 packed_ctx=True),
         "int8": dict(precision="int8", packed_width=2)}
# (world, geometry, kernel_warps)
FORWARDS = {"x2_2ranks": (2, "x2", True), "x2_4ranks": (4, "x2", True),
            "x2_2ranks_exact_warps": (2, "x2", False),
            "x1.5_2ranks": (2, "x1.5", True)}


@pytest.fixture(scope="module")
def references(lssvc_params):
    """Per geometry: the inputs and JAX's and the port's unsharded
    forwards, chained as deep as the geometry says."""
    jparams, tparams = lssvc_params
    tp = {k: torch.from_numpy(v) for k, v in tparams.items()}
    out = {}
    for name, (el_hw, bl_hw, scale, frames) in GEOMETRY.items():
        x_bl, x_el, dpb = _frame_inputs(el_hw, bl_hw, 0)
        fwd = jax.jit(lambda p, *a, el_hw=el_hw, scale=scale:
                      jl.forward_one_frame(p, *a, el_hw, scale,
                                           (0, 0, 0, 0)))
        jd = dpb
        td = {k: torch.tensor(v) for k, v in dpb.items()}
        refs = []
        for _ in range(frames):
            j = fwd(jparams, x_bl, x_el, *(jd[k] for k in DPB_KEYS))
            with torch.no_grad():
                t = tl.forward_one_frame(tp, torch.tensor(x_bl),
                                         torch.tensor(x_el),
                                         *(td[k] for k in DPB_KEYS), el_hw,
                                         scale, (0, 0, 0, 0))
            refs.append((j, t))
            jd, td = j["dpb"], t["dpb"]
        out[name] = (x_bl, x_el, dpb, refs)
    return out


@pytest.fixture(scope="module")
def intra_case():
    """IntraSS at EL 128 / BL 64: the JAX package's unsharded forward and
    the bridged parameters (`tests/test_spatial.py:283-307`)."""
    el_hw, bl_hw = (128, 128), (64, 64)
    jparams = j_init_intra_ss(seed=0)
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    x_bl = jax.random.uniform(ks[0], (1, *bl_hw, 3))
    x_el = jax.random.uniform(ks[1], (1, *el_hw, 3))
    ref = jax.jit(lambda p, a, b: j_intra.forward(p, a, b, el_hw,
                                                  (0, 0, 0, 0)))(
        jparams, x_bl, x_el)
    tparams = params_from_jax({k: _np(v) for k, v in jparams.items()},
                              "intra_ss")
    el = {k: v.numpy() for k, v in tparams.items()
          if not k.startswith(BL_PREFIX)}
    bl = {k[len(BL_PREFIX):]: v.numpy() for k, v in tparams.items()
          if k.startswith(BL_PREFIX)}
    with torch.no_grad():
        port = t_intra.forward({k: torch.from_numpy(v) for k, v in el.items()},
                               {k: torch.from_numpy(v) for k, v in bl.items()},
                               torch.tensor(_np(x_bl)),
                               torch.tensor(_np(x_el)), el_hw, (0, 0, 0, 0))
    return el, bl, _np(x_bl), _np(x_el), el_hw, ref, port


@pytest.fixture(scope="module")
def ranks(lssvc_params, references, intra_case, tmp_path_factory):
    """ranks(world): one start of `world` ranks for every case of that
    world (the halo warps, the P-frame forwards, the I-frame forward),
    cached."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _run_world(world, lssvc_params[1], references,
                                      intra_case,
                                      tmp_path_factory.mktemp(f"r{world}"))
        return cache[world]

    return get


def _run_world(world, tparams, references, intra_case, tmp):
    cases = _warp_cases(world)
    assert [c[0] for c in cases] == WARP_IDS[world]
    todo = [("warp_cases", ([c[1] for c in cases],))]
    names = [n for n, f in FORWARDS.items() if f[0] == world]
    for name in names:
        _, geometry, kernel_warps = FORWARDS[name]
        el_hw, _, scale, frames = GEOMETRY[geometry]
        x_bl, x_el, dpb, _ = references[geometry]
        chain = [(x_bl, x_el, dpb)] + [(x_bl, x_el, None)] * (frames - 1)
        todo.append(("spatial_frames", (
            tparams, chain if kernel_warps else chain[:1], el_hw, scale,
            kernel_warps, 16, 44)))
    el, bl, x_bl, x_el, el_hw, _, _ = intra_case
    todo.append(("spatial_intra", (el, bl, x_bl, x_el, el_hw)))
    todo.append(("strip_ops", (STRIP_HEIGHTS[world],)))
    keys = ["warps", *names, "intra", "ops"]
    if world == 2:
        x_bl, x_el, dpb, _ = references["x2"]
        table = calibrate_video({k: torch.from_numpy(v) for k, v in
                                 tparams.items()}, size=128, frames=1,
                                device="cpu")
        modes = [dict(MODES[m], int8_table=table) if m == "int8"
                 else MODES[m] for m in MODES]
        todo.append(("spatial_modes", (tparams, (x_bl, x_el, dpb),
                                       GEOMETRY["x2"][0], modes)))
        keys.append("modes")
    got = torch_dist.run(torch_dist.jobs, world, tmp, todo)
    per_rank = [dict(zip(keys, r)) for r in got]
    return cases, per_rank


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4)
                                        for c in WARP_IDS[w]])
def test_halo_warps_match_jax(ranks, world, case):
    cases, per_rank = ranks(world)
    _check_warp(world, cases, [r["warps"] for r in per_rank], case)


def _forward(ranks, references, name):
    world, geometry, kernel_warps = FORWARDS[name]
    _, per_rank = ranks(world)
    refs = references[geometry][3]
    return (refs if kernel_warps else refs[:1]), [r[name] for r in per_rank]


@pytest.mark.parametrize("name", list(FORWARDS))
def test_spatial_forward_matches_jax(ranks, references, name):
    refs, got_ranks = _forward(ranks, references, name)
    for rank in got_ranks[1:]:  # every rank gathers the same frames, bits
        for a, b in zip(rank["frames"], got_ranks[0]["frames"]):
            assert a["bits"] == b["bits"]
            for k in DPB_KEYS:
                assert torch.equal(a["dpb"][k], b["dpb"][k])
    for i, ((j, _), got) in enumerate(zip(refs, got_ranks[0]["frames"])):
        bits_ref = float(j["bit_bl"] + j["bit_el"])
        assert abs(got["bits"] - bits_ref) / max(bits_ref, 1.0) < 1e-3, \
            (name, i, got["bits"], bits_ref)
        if i == 0:
            for k in DPB_KEYS:
                np.testing.assert_allclose(got["dpb"][k].numpy(),
                                           _np(j["dpb"][k]), rtol=1e-3,
                                           atol=1e-3, err_msg=f"{name} {k}")
        else:  # chained: frame 1's drift amplifies (test_spatial.py:275)
            r2 = _np(j["dpb"]["ref_frame_el"])
            np.testing.assert_allclose(got["dpb"]["ref_frame_el"].numpy(),
                                       r2, rtol=0,
                                       atol=5e-3 * np.abs(r2).max())


@pytest.mark.parametrize("name", list(FORWARDS))
def test_spatial_forward_matches_port_unsharded(ranks, references, name):
    """The strips against the port's own unsharded forward: the bound
    found is the JAX test's (rtol = atol = 1e-3 on frame 1, 5e-3 of the
    max on frame 2; measured on these inputs at 2 and 4 ranks: at most
    8.3e-4 on frame 1's EL picture, of max 377, and 4.2 on frame 2's, of
    max 2.6e4); every P-frame warps 14 times through `flow_warp` (pairs
    included) and once through `grouped_warp` on every rank."""
    refs, got_ranks = _forward(ranks, references, name)
    for i, ((_, t), got) in enumerate(zip(refs, got_ranks[0]["frames"])):
        bits = float(t["bit_bl"] + t["bit_el"])
        assert abs(got["bits"] - bits) / max(bits, 1.0) < 1e-3
        for k in DPB_KEYS:
            want = t["dpb"][k].numpy()
            tol = 1e-3 if i == 0 else 5e-3 * np.abs(want).max()
            np.testing.assert_allclose(got["dpb"][k].numpy(), want,
                                       rtol=1e-3 if i == 0 else 0, atol=tol,
                                       err_msg=f"{name} frame {i} {k}")
    frames = len(refs)
    for rank in got_ranks:
        counts = rank["counts"]
        assert sum(counts["flow_warp"].values()) == 14 * frames
        assert sum(counts["grouped_warp"].values()) == frames
        if not FORWARDS[name][2]:  # kernel_warps off: exact branch only
            assert counts["flow_warp"]["exact"] == 14 * frames
            assert counts["grouped_warp"]["exact"] == frames


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", STRIP_OPS)
def test_strip_forms_of_the_ops(ranks, world, op):
    """Each op's strip form (`ops/strips.py`) at the models' conv shapes,
    strides and paddings, at even and odd strip starts, and where its
    output level is too short to split (a 9-row strided output on 2 or 4
    ranks, computed whole), against the op on the whole frame."""
    _, per_rank = ranks(world)
    for h in STRIP_HEIGHTS[world]:
        for rank in per_rank:
            assert rank["ops"][f"{op}_h{h}"] <= 1e-5, (op, h, rank["ops"])


def _rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("mode", list(MODES))
def test_spatial_forward_other_modes(ranks, mode):
    """The packed domain (with the fused packed pair store) and int8 on
    strips, against the port's unsharded frame in the same mode on 2
    ranks.  fp32 packed as fp32 (rtol = atol = 1e-3, bits 1e-3).  bf16
    and int8 are chaotic at random init: moving the frame (x_bl, x_el)
    by 1e-6 relative moves the EL picture by about 2% (bf16) and 4-5%
    (int8) relative RMS (measured), so the strips are held to twice the
    distance that move makes; the bits, summed in bf16, within 1e-2
    relative (two bf16 ulps)."""
    _, per_rank = ranks(2)
    got = per_rank[0]["modes"][list(MODES).index(mode)]
    for other in per_rank[1:]:
        assert other["modes"][list(MODES).index(mode)]["bits"] == got["bits"]
    ref = got["ref"]
    if mode.startswith("fp32"):
        assert abs(got["bits"] - ref["bits"]) <= 1e-3 * ref["bits"]
        for k in DPB_KEYS:
            np.testing.assert_allclose(got["dpb"][k].numpy(),
                                       ref["dpb"][k].numpy(), rtol=1e-3,
                                       atol=1e-3, err_msg=k)
        return
    assert abs(got["bits"] - ref["bits"]) <= 1e-2 * ref["bits"]
    for k in ("ref_frame_el", "ref_feature_el", "ref_frame_bl",
              "ref_feature_bl"):
        floor = _rel_rms(got["moved"]["dpb"][k], ref["dpb"][k])
        dist = _rel_rms(got["dpb"][k], ref["dpb"][k])
        print(f"{mode} {k}: strips {dist:.4f}, moved input {floor:.4f}")
        assert dist <= 2 * floor + 1e-3, (k, dist, floor)


@pytest.mark.parametrize("world", [2, 4])
def test_level_plan(ranks, world):
    """The split rule: a level splits when the rank count divides its
    height (EL 128 on 4 ranks computes 1/64, 2 rows, whole)."""
    _, per_rank = ranks(world)
    plan = per_rank[0][f"x2_{world}ranks"]["plan"]
    assert plan == {h: h % world == 0 and h >= world for h in plan}
    assert plan[2] is (world == 2) and plan[8] is True


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_intra_forward_matches_jax(ranks, intra_case, world):
    """IntraSS on strips (warp-free) against the JAX package's unsharded
    forward (`tests/test_spatial.py:283-307`'s tolerances) and the port's."""
    _, per_rank = ranks(world)
    *_, ref, port = intra_case
    r = _np(ref["x_hat_el"])
    bits_ref = float(ref["bit_bl"] + ref["bit_el"])
    for got in (rank["intra"] for rank in per_rank):
        np.testing.assert_allclose(got["x_hat_el"].numpy(), r, rtol=0,
                                   atol=max(1e-3, 1e-3 * np.abs(r).max()))
        assert abs(got["bits"] - bits_ref) / max(bits_ref, 1.0) < 1e-3
        np.testing.assert_allclose(got["x_hat_el"].numpy(),
                                   port["x_hat_el"].numpy(), rtol=1e-3,
                                   atol=1e-3)
