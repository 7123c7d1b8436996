"""The codecs' parameters made from a run's seed: a frozen copy of the
program's `lssvc_tpu_torch/models/init.py` (commit 4d8626f; the same
shapes, names and distributions: unit-gain xavier normal conv weights with
bias 0.01, a zero OffsetDiversity offset/mask head, GDN at identity, Bitparm
N(0, 0.01), the Balle EntropyBottleneck init), with one change: the random
draws are not made leaf by leaf on the host.  `ParamSet` records each
draw's shape and scale as a placeholder; `Draws.realize` then makes every
normal draw in one `torch.randn` and every uniform draw in one
`torch.rand` on the device, from a `torch.Generator` there seeded with the
run's seed, and copies the constant leaves there in one transfer.  The
numbers are not the program's init's: these are the benchmark's inputs.
Cheng2020Anchor is left out (no cell runs it).
"""

from __future__ import annotations

import math

import torch


class _Draw:
    """A placeholder leaf: a draw to make in `Draws.realize`."""

    def __init__(self, kind, shape, std):
        self.kind, self.shape, self.std = kind, tuple(shape), std

    def numel(self):
        return math.prod(self.shape)


class Draws:
    """The random leaves of one or more `init_*` calls, made together."""

    def normal(self, shape, std):
        return _Draw("normal", shape, std)

    def uniform_centered(self, shape):
        """uniform in [-0.5, 0.5)"""
        return _Draw("uniform", shape, 1.0)

    @staticmethod
    def realize(params: dict, seed: int, device) -> dict:
        """`params` with every placeholder drawn and every leaf on
        `device` (float32).  Two generator calls and one copy."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        out = {}
        for kind, fill in (("normal", torch.randn), ("uniform", torch.rand)):
            keys = [k for k, v in params.items()
                    if isinstance(v, _Draw) and v.kind == kind]
            total = sum(params[k].numel() for k in keys)
            flat = fill(total, generator=gen, device=device,
                        dtype=torch.float32)
            if kind == "uniform":
                flat -= 0.5
            at = 0
            for k in keys:
                d = params[k]
                out[k] = flat[at:at + d.numel()].view(d.shape)
                if kind == "normal":
                    out[k].mul_(d.std)
                at += d.numel()
        consts = [k for k, v in params.items() if not isinstance(v, _Draw)]
        host = torch.cat([params[k].float().reshape(-1) for k in consts])
        dev = host.to(device)
        at = 0
        for k in consts:
            n = params[k].numel()
            out[k] = dev[at:at + n].view(params[k].shape)
            at += n
        return {k: out[k] for k in params}


class ParamSet:
    """Named parameters of the reference's blocks, drawn from one generator
    in the order the blocks are added."""

    def __init__(self, draws: "Draws"):
        self.d: dict[str, torch.Tensor] = {}
        self.gen = draws

    def _normal(self, shape, std):
        return self.gen.normal(shape, std)

    # -- primitives -----------------------------------------------------------

    def conv(self, name, cin, cout, k, groups: int = 1):
        fan_in = cin // groups * k * k
        fan_out = cout // groups * k * k
        std = math.sqrt(2.0 / (fan_in + fan_out))
        self.d[f"{name}.weight"] = self._normal((cout, cin // groups, k, k), std)
        self.d[f"{name}.bias"] = torch.full((cout,), 0.01)

    def deconv(self, name, cin, cout, k):
        std = math.sqrt(2.0 / (cin * k * k + cout * k * k))
        self.d[f"{name}.weight"] = self._normal((cin, cout, k, k), std)
        self.d[f"{name}.bias"] = torch.full((cout,), 0.01)

    def conv_zero(self, name, cin, cout, k):
        """Zero conv: OffsetDiversity's offset/mask head starts as an identity
        warp (offsets 0, masks sigmoid(0)), as in the JAX package."""
        self.d[f"{name}.weight"] = torch.zeros((cout, cin, k, k))
        self.d[f"{name}.bias"] = torch.zeros((cout,))

    def gdn(self, name, ch):
        ped = (2.0 ** -18) ** 2
        self.d[f"{name}.beta"] = torch.sqrt(
            torch.ones(ch, dtype=torch.float64) + ped).float()
        self.d[f"{name}.gamma"] = torch.sqrt(
            0.1 * torch.eye(ch, dtype=torch.float64) + ped).float()

    def bitparm(self, name, ch, final=False):
        for pname in (("h", "b") if final else ("h", "b", "a")):
            self.d[f"{name}.{pname}"] = self._normal((1, ch, 1, 1), 0.01)

    def bit_estimator(self, name, ch):
        self.bitparm(f"{name}.f1", ch)
        self.bitparm(f"{name}.f2", ch)
        self.bitparm(f"{name}.f3", ch)
        self.bitparm(f"{name}.f4", ch, final=True)

    def entropy_bottleneck(self, name, ch, filters=(3, 3, 3, 3),
                           init_scale=10.0):
        fs = (1,) + tuple(filters) + (1,)
        scale = init_scale ** (1 / (len(filters) + 1))
        for i in range(len(filters) + 1):
            init = math.log(math.expm1(1 / scale / fs[i + 1]))
            self.d[f"{name}._matrices.{i}"] = torch.full(
                (ch, fs[i + 1], fs[i]), init)
            self.d[f"{name}._biases.{i}"] = self.gen.uniform_centered(
                (ch, fs[i + 1], 1))
            if i < len(filters):
                self.d[f"{name}._factors.{i}"] = torch.zeros((ch, fs[i + 1], 1))
        self.d[f"{name}.quantiles"] = torch.tensor(
            [-init_scale, 0.0, init_scale]).repeat(ch, 1, 1)

    # -- composite blocks -----------------------------------------------------

    def res_block(self, name, ch, bottleneck=False):
        inner = ch // 2 if bottleneck else ch
        self.conv(f"{name}.conv1", ch, inner, 3)
        self.conv(f"{name}.conv2", inner, ch, 3)

    def residual_block(self, name, cin, cout):
        self.conv(f"{name}.conv1", cin, cout, 3)
        self.conv(f"{name}.conv2", cout, cout, 3)

    def residual_block_with_stride(self, name, cin, cout, stride=2):
        self.conv(f"{name}.conv1", cin, cout, 3)
        self.conv(f"{name}.conv2", cout, cout, 3)
        self.gdn(f"{name}.gdn", cout)
        if stride != 1:
            self.conv(f"{name}.downsample", cin, cout, 1)

    def residual_block_upsample(self, name, cin, cout, r=2):
        self.conv(f"{name}.subpel_conv.0", cin, cout * r * r, 3)
        self.conv(f"{name}.conv", cout, cout, 3)
        self.gdn(f"{name}.igdn", cout)
        self.conv(f"{name}.upsample.0", cin, cout * r * r, 3)

    def subpel(self, name, cin, cout, r=2, k=3):
        self.conv(f"{name}.0", cin, cout * r * r, k)

    def depth_conv(self, name, cin, cout, stride=1):
        if stride != 1:
            self.conv(f"{name}.adaptor", cin, cout, 2)
        elif cin != cout:
            self.conv(f"{name}.adaptor", cin, cout, 1)
        self.conv(f"{name}.conv1.0", cin, cin, 1)
        self.conv(f"{name}.depth_conv", cin, cin, 3, groups=cin)
        self.conv(f"{name}.conv2", cin, cout, 1)

    def conv_ffn(self, name, ch):
        internal = max(min(ch * 4, 1024), ch * 2)
        self.conv(f"{name}.conv.0", ch, internal, 1)
        self.conv(f"{name}.conv.2", internal, ch, 1)

    def depth_conv_block(self, name, cin, cout, stride=1):
        self.depth_conv(f"{name}.block.0", cin, cout, stride)
        self.conv_ffn(f"{name}.block.1", cout)

    def unet(self, name, cin, cout):
        self.depth_conv_block(f"{name}.conv1", cin, 32)
        self.depth_conv_block(f"{name}.conv2", 32, 64)
        self.depth_conv_block(f"{name}.conv3", 64, 128)
        for i in range(4):
            self.depth_conv_block(f"{name}.context_refine.{i}", 128, 128)
        self.subpel(f"{name}.up3", 128, 64, 2, k=1)
        self.depth_conv_block(f"{name}.up_conv3", 128, 64)
        self.subpel(f"{name}.up2", 64, 32, 2, k=1)
        self.depth_conv_block(f"{name}.up_conv2", 64, cout)

    def feature_extractor_3scale(self, name, chans):
        c1, c2, c3 = chans
        self.conv(f"{name}.conv1", c1[0], c1[1], 3)
        self.res_block(f"{name}.res_block1", c1[1])
        self.conv(f"{name}.conv2", c1[1], c2, 3)
        self.res_block(f"{name}.res_block2", c2)
        self.conv(f"{name}.conv3", c2, c3, 3)
        self.res_block(f"{name}.res_block3", c3)

    def multi_scale_context_fusion(self, name, c1, c2, c3):
        self.subpel(f"{name}.conv3_up", c3, c2, 2)
        self.res_block(f"{name}.res_block3_up", c2)
        self.conv(f"{name}.conv3_out", c3, c3, 3)
        self.res_block(f"{name}.res_block3_out", c3)
        self.subpel(f"{name}.conv2_up", c2 * 2, c1, 2)
        self.res_block(f"{name}.res_block2_up", c1)
        self.conv(f"{name}.conv2_out", c2 * 2, c2, 3)
        self.res_block(f"{name}.res_block2_out", c2)
        self.conv(f"{name}.conv1_out", c1 * 2, c1, 3)
        self.res_block(f"{name}.res_block1_out", c1)

    def me_basic(self, name):
        self.conv(f"{name}.conv1", 8, 32, 7)
        self.conv(f"{name}.conv2", 32, 64, 7)
        self.conv(f"{name}.conv3", 64, 32, 7)
        self.conv(f"{name}.conv4", 32, 16, 7)
        self.conv(f"{name}.conv5", 16, 2, 7)

    def spynet(self, name):
        for i in range(4):
            self.me_basic(f"{name}.moduleBasic.{i}")

    def gdn_res_encoder(self, name, cn=64, cm=96):
        self.conv(f"{name}.conv1", cn + 3, cn, 3)
        self.gdn(f"{name}.gdn1", cn)
        self.res_block(f"{name}.res1", cn * 2, bottleneck=True)
        self.conv(f"{name}.conv2", cn * 2, cn, 3)
        self.gdn(f"{name}.gdn2", cn)
        self.res_block(f"{name}.res2", cn * 2, bottleneck=True)
        self.conv(f"{name}.conv3", cn * 2, cn, 3)
        self.gdn(f"{name}.gdn3", cn)
        self.conv(f"{name}.conv4", cn, cm, 3)

    def gdn_res_decoder(self, name, cn=64, cm=96):
        self.subpel(f"{name}.up1", cm, cn, 2)
        self.gdn(f"{name}.gdn1", cn)
        self.subpel(f"{name}.up2", cn, cn, 2)
        self.gdn(f"{name}.gdn2", cn)
        self.res_block(f"{name}.res1", cn * 2, bottleneck=True)
        self.subpel(f"{name}.up3", cn * 2, cn, 2)
        self.gdn(f"{name}.gdn3", cn)
        self.res_block(f"{name}.res2", cn * 2, bottleneck=True)
        self.subpel(f"{name}.up4", cn * 2, 32, 2)

    def recon_generation_simple(self, name, ctx=64, res=32, ch=64):
        self.conv(f"{name}.feature_conv.0", ctx + res, ch, 3)
        self.res_block(f"{name}.feature_conv.1", ch)
        self.res_block(f"{name}.feature_conv.2", ch)
        self.conv(f"{name}.recon_conv", ch, 3, 3)


# ---------------------------------------------------------------------------
# DMC (base-layer inter codec) — shapes per `dmc_net.py:159-266`

def init_dmc(generator: "Draws", prefix: str = "") -> dict:
    b = ParamSet(generator)
    mv, cn, cm = 128, 64, 96
    b.spynet("optic_flow")

    for base in (0, 4, 8):
        b.conv(f"mv_encoder.{base}", 2 if base == 0 else mv, mv, 3)
        b.gdn(f"mv_encoder.{base + 1}", mv)
        b.res_block(f"mv_encoder.{base + 2}", mv)
    b.conv("mv_encoder.12", mv, mv, 3)

    b.conv("mv_prior_encoder.0", mv, cn, 3)
    b.conv("mv_prior_encoder.2", cn, cn, 3)
    b.conv("mv_prior_encoder.4", cn, cn, 3)
    b.deconv("mv_prior_decoder.0", cn, mv, 3)
    b.deconv("mv_prior_decoder.2", mv, mv * 3 // 2, 3)
    b.deconv("mv_prior_decoder.4", mv * 3 // 2, mv * 2, 3)

    b.deconv("mv_decoder.0", mv, mv, 3)
    b.res_block("mv_decoder.2", mv)
    b.gdn("mv_decoder.3", mv)
    b.deconv("mv_decoder.4", mv, mv, 3)
    b.gdn("mv_decoder.5", mv)
    b.deconv("mv_decoder.6", mv, mv, 3)
    b.gdn("mv_decoder.7", mv)
    b.deconv("mv_decoder.8", mv, 2, 3)

    b.conv("feature_adaptor_I", 3, cn, 3)
    b.conv("feature_adaptor_P", cn, cn, 1)
    b.feature_extractor_3scale("feature_extractor", ((cn, cn), cn, cn))
    b.multi_scale_context_fusion("context_fusion_net", cn, cn, cn)

    b.gdn_res_encoder("res_encoder", cn, cm)
    b.conv("res_prior_encoder.0", cm, cn, 3)
    b.conv("res_prior_encoder.2", cn, cn, 3)
    b.conv("res_prior_encoder.4", cn, cn, 3)
    b.deconv("res_prior_decoder.0", cn, cm, 3)
    b.deconv("res_prior_decoder.2", cm, cm * 3 // 2, 3)
    b.deconv("res_prior_decoder.4", cm * 3 // 2, cm * 2, 3)

    b.conv("temporal_prior_encoder.conv1", cn, cn, 3)
    b.gdn("temporal_prior_encoder.gdn1", cn)
    b.conv("temporal_prior_encoder.conv2", cn * 2, cm, 3)
    b.gdn("temporal_prior_encoder.gdn2", cm)
    b.conv("temporal_prior_encoder.conv3", cm + cn, cm * 3 // 2, 3)
    b.gdn("temporal_prior_encoder.gdn3", cm * 3 // 2)
    b.conv("temporal_prior_encoder.conv4", cm * 3 // 2, cm * 2, 3)

    b.conv("res_entropy_parameter.0", cm * 4, cm * 10 // 3, 3)
    b.conv("res_entropy_parameter.2", cm * 10 // 3, cm * 8 // 3, 3)
    b.conv("res_entropy_parameter.4", cm * 8 // 3, cm * 2, 3)

    b.gdn_res_decoder("res_decoder", cn, cm)
    b.recon_generation_simple("recon_generation_net")

    b.bit_estimator("bit_estimator_z", cn)
    b.bit_estimator("bit_estimator_z_mv", cn)
    return {prefix + k: v for k, v in b.d.items()}


# ---------------------------------------------------------------------------
# LSSVC (two-layer inter codec) — shapes per `LSSVC_net.py:12-139` with the
# channel plan g_ch = 48/64/96/96/128 (`lssvc_modules.py:8-12`)

G1, G2, G4, G8, G16 = 48, 64, 96, 96, 128


def init_lssvc(generator: "Draws") -> dict:
    b = ParamSet(generator)
    cn, mv = 64, 64

    b.conv("feature_adaptor_EL_I", 3, G1, 3)
    b.conv("feature_adaptor_EL_first_P", cn, G1, 3)
    b.conv("feature_adaptor_EL", G1, G1, 3)

    # MvResampler
    b.conv("mv_resampler.conv1.0", 2, 64, 3)
    b.conv("mv_resampler.conv1.2", 64, 64, 3)
    b.conv("mv_resampler.conv2.0", 64, 64, 3)
    b.conv("mv_resampler.conv2.2", 64, 64, 3)
    b.depth_conv_block("mv_resampler.feature_refine.0", 64, 64)
    b.depth_conv_block("mv_resampler.feature_refine.1", 64, 64)
    b.conv("mv_resampler.recon_conv", 64, 2, 3)

    # TextureResampler
    b.conv("texture_resampler.conv_adaptor.base_layer_adaptor", 64, 64, 3)
    b.conv("texture_resampler.conv_adaptor.enhance_layer_adaptor", G1, 64, 3)
    b.conv("texture_resampler.conv1.0", 64, 64, 3)
    b.conv("texture_resampler.conv1.2", 64, 64, 3)
    b.conv("texture_resampler.conv2.0", 64, 64, 3)
    b.conv("texture_resampler.conv2.2", 64, 64, 3)
    b.depth_conv_block("texture_resampler.feature_refine.0", 64, 64)
    b.depth_conv_block("texture_resampler.feature_refine.1", 64, 64)

    # LayerPriorResampler
    b.conv("layer_prior_resampler.conv_adaptor.base_layer_adaptor", 96, 96, 3)
    b.conv("layer_prior_resampler.conv_adaptor.enhance_layer_adaptor", G16, 96, 3)
    b.conv("layer_prior_resampler.conv1.0", 96, 96, 3)
    b.conv("layer_prior_resampler.conv1.2", 96, 96, 3)
    b.conv("layer_prior_resampler.conv2.0", 96, 96, 3)
    b.conv("layer_prior_resampler.conv2.2", 96, G16, 3)
    b.depth_conv_block("layer_prior_resampler.feature_refine.0", G16, G16)
    b.depth_conv_block("layer_prior_resampler.feature_refine.1", G16, G16)

    b.feature_extractor_3scale("feature_extractor", ((G1, G1), G2, G4))
    b.feature_extractor_3scale("texture_extractor", ((64, G1), G2, G4))
    b.multi_scale_context_fusion("context_fusion_net", G1, G2, G4)

    # HybridWeightGenerator
    for i, ch in ((1, G1), (2, G2), (3, G4)):
        b.conv(f"weight_map_generator.generator{i}.0", ch * 2, 64, 3)
        b.res_block(f"weight_map_generator.generator{i}.1", 64)
        b.conv(f"weight_map_generator.generator{i}.2", 64, 2, 3)

    # PriorFusion + spatial prior
    b.depth_conv_block("prior_fusion_net.prior_fusion_conv.0", G16 * 3, G16 * 3)
    b.depth_conv_block("prior_fusion_net.prior_fusion_conv.1", G16 * 3, G16 * 2)
    for i in (1, 2, 3):
        b.conv(f"y_spatial_prior_adaptor_{i}", G16 * 3, G16 * 3, 1)
    b.depth_conv_block("y_spatial_prior.0", G16 * 3, G16 * 3)
    b.depth_conv_block("y_spatial_prior.1", G16 * 3, G16 * 3)
    b.depth_conv_block("y_spatial_prior.2", G16 * 3, G16 * 2)

    # EL residual AE
    b.conv("res_encoder.conv1", G1 + 3, G2, 3)
    b.res_block("res_encoder.res1", G2 * 2, bottleneck=True)
    b.conv("res_encoder.conv2", G2 * 2, G4, 3)
    b.res_block("res_encoder.res2", G4 * 2, bottleneck=True)
    b.conv("res_encoder.conv3", G4 * 2, G8, 3)
    b.conv("res_encoder.conv4", G8, G16, 3)

    b.conv("res_prior_encoder.0", G16, G16, 3)
    b.conv("res_prior_encoder.2", G16, G16, 3)
    b.conv("res_prior_encoder.4", G16, G16, 3)
    b.conv("res_prior_decoder.0", G16, G16, 3)
    b.subpel("res_prior_decoder.2", G16, G16, 2, k=1)
    b.conv("res_prior_decoder.4", G16, G16, 3)
    b.subpel("res_prior_decoder.6", G16, G16, 2, k=1)
    b.conv("res_prior_decoder.8", G16, G16, 3)

    b.conv("temporal_prior_encoder.0", G4, G8, 3)
    b.conv("temporal_prior_encoder.2", G8, G16, 3)

    b.subpel("res_decoder.up1", G16, G8, 2)
    b.subpel("res_decoder.up2", G8, G4, 2)
    b.res_block("res_decoder.res1", G4 * 2, bottleneck=True)
    b.subpel("res_decoder.up3", G4 * 2, G2, 2)
    b.res_block("res_decoder.res2", G2 * 2, bottleneck=True)
    b.subpel("res_decoder.up4", G2 * 2, 32, 2)

    b.conv("recon_generation_net.first_conv", G1 + 32, G1, 3)
    b.unet("recon_generation_net.unet_1", G1, G1)
    b.unet("recon_generation_net.unet_2", G1, G1)
    b.conv("recon_generation_net.recon_conv", G1, 3, 3)

    # flow part
    b.spynet("optic_flow")

    # OffsetDiversity
    aux = G1 + 3 + 2
    b.conv("align.conv_offset.0", aux, G2, 3)
    b.conv("align.conv_offset.2", G2, G2, 3)
    b.conv_zero("align.conv_offset.4", G2, 3 * 16 * 2, 3)
    b.conv("align.fusion", G1 * 2, G1, 1, groups=16)

    b.conv("mv_ctx_transform.transform.0", 2, mv, 3)
    b.res_block("mv_ctx_transform.transform.1", mv)

    # MVResEncoder
    b.conv("mv_encoder.encoder1.0", 2, mv, 3)
    b.gdn("mv_encoder.encoder1.1", mv)
    b.res_block("mv_encoder.encoder1.2", mv)
    b.conv("mv_encoder.encoder2.0", mv * 2, mv, 3)
    b.gdn("mv_encoder.encoder2.1", mv)
    b.res_block("mv_encoder.encoder2.2", mv)
    b.conv("mv_encoder.encoder2.4", mv, mv, 3)
    b.gdn("mv_encoder.encoder2.5", mv)
    b.res_block("mv_encoder.encoder2.6", mv)
    b.conv("mv_encoder.encoder2.8", mv, mv, 3)

    b.conv("mv_prior_encoder.0", mv, mv, 3)
    b.conv("mv_prior_encoder.2", mv, mv, 3)
    b.conv("mv_prior_encoder.4", mv, mv, 3)
    b.subpel("mv_prior_decoder.0", mv, mv, 2)
    b.subpel("mv_prior_decoder.2", mv, mv * 3 // 2, 2)
    b.conv("mv_prior_decoder.4", mv * 3 // 2, mv * 2, 3)

    # MVResDecoder
    b.subpel("mv_decoder.decoder1.0", mv, mv, 2)
    b.res_block("mv_decoder.decoder1.2", mv)
    b.gdn("mv_decoder.decoder1.3", mv)
    b.subpel("mv_decoder.decoder1.4", mv, mv, 2)
    b.gdn("mv_decoder.decoder1.5", mv)
    b.subpel("mv_decoder.decoder1.6", mv, mv, 2)
    b.gdn("mv_decoder.decoder1.7", mv)
    b.conv("mv_decoder.decoder2.0", mv * 2, mv, 3)
    b.subpel("mv_decoder.decoder2.2", mv, 2, 2)

    # mv_ctx_prior_encoder
    b.conv("mv_ctx_prior_encoder.0", 2, mv, 3)
    b.gdn("mv_ctx_prior_encoder.1", mv)
    b.conv("mv_ctx_prior_encoder.2", mv, mv, 3)
    b.gdn("mv_ctx_prior_encoder.3", mv)
    b.conv("mv_ctx_prior_encoder.4", mv, mv, 3)
    b.gdn("mv_ctx_prior_encoder.5", mv)
    b.conv("mv_ctx_prior_encoder.6", mv, mv, 3)

    b.conv("mv_prior_fusion.0", mv * 3, mv * 8 // 3, 3)
    b.conv("mv_prior_fusion.2", mv * 8 // 3, mv * 7 // 3, 3)
    b.conv("mv_prior_fusion.4", mv * 7 // 3, mv * 2, 3)

    b.bit_estimator("bit_estimator_z", G16)
    b.bit_estimator("bit_estimator_z_mv", mv)

    params = b.d
    params.update(init_dmc(generator, prefix="base_layer_model."))
    return params


# ---------------------------------------------------------------------------
# IntraNoAR — shapes per `priors.py:112-162`

def init_intra_noar(generator: "Draws", N: int = 192,
                    prefix: str = "") -> dict:
    b = ParamSet(generator)
    b.residual_block_with_stride("g_a.0", 3, N)
    b.residual_block("g_a.1", N, N)
    b.residual_block_with_stride("g_a.2", N, N)
    b.residual_block("g_a.3", N, N)
    b.residual_block_with_stride("g_a.4", N, N)
    b.residual_block("g_a.5", N, N)
    b.conv("g_a.6", N, N, 3)

    for i in range(5):
        b.conv(f"h_a.{2 * i}", N, N, 3)
    b.conv("h_s.0", N, N, 3)
    b.subpel("h_s.2", N, N, 2)
    b.conv("h_s.4", N, N * 3 // 2, 3)
    b.subpel("h_s.6", N * 3 // 2, N * 3 // 2, 2)
    b.conv("h_s.8", N * 3 // 2, N * 2, 3)

    for i in (0, 2, 4, 6):
        b.residual_block(f"g_s.{i}", N, N)
        if i < 6:
            b.residual_block_upsample(f"g_s.{i + 1}", N, N)
    b.subpel("g_s.7", N, 3, 2)

    b.entropy_bottleneck("entropy_bottleneck", N)
    return {prefix + k: v for k, v in b.d.items()}


# ---------------------------------------------------------------------------
# IntraSS — shapes per `IntraSS.py:74-113` (+ intra blocks `layers.py`)

def init_intra_ss(generator: "Draws", channel_BL: int = 192) -> dict:
    cn, cm = 64, 96
    b = ParamSet(generator)

    b.conv("texture_resampler.conv_adaptor.0", 3, 64, 3)
    b.conv("texture_resampler.conv_adaptor.2", 64, 64, 3)
    b.conv("layer_prior_resampler.conv_adaptor.0", channel_BL, cm, 3)
    b.conv("layer_prior_resampler.conv_adaptor.2", cm, cm, 3)

    b.feature_extractor_3scale("texture_extractor", ((64, 64), 64, 64))
    b.multi_scale_context_fusion("context_fusion_net", 64, 64, 64)

    b.gdn_res_encoder("g_a", cn, cm)
    b.conv("h_a.0", cm, cn, 3)
    b.conv("h_a.2", cn, cn, 3)
    b.conv("h_a.4", cn, cn, 3)
    b.subpel("h_s.0", cn, cm, 2)
    b.subpel("h_s.2", cm, cm * 3 // 2, 2)
    b.conv("h_s.4", cm * 3 // 2, cm * 2, 3)
    b.gdn_res_decoder("g_s", cn, cm)
    b.recon_generation_simple("recon_net")

    # intra PriorFusion (`layers.py:473-492`)
    b.conv("prior_fusion_net.context_parameters.0", cn, cm * 3 // 2, 3)
    b.conv("prior_fusion_net.context_parameters.2", cm * 3 // 2, cm * 2, 3)
    b.conv("prior_fusion_net.params_net.0", cm * 5, cm * 4, 3)
    b.conv("prior_fusion_net.params_net.2", cm * 4, cm * 3, 3)
    b.conv("prior_fusion_net.params_net.4", cm * 3, cm * 2, 3)

    b.entropy_bottleneck("entropy_bottleneck", cn)
    params = b.d
    params.update(init_intra_noar(generator, channel_BL,
                                  prefix="base_layer_model."))
    return params
