"""The port's Cheng2020Anchor against the JAX package's (N=32, 64x64, fp32).

The JAX package has no init for it: its params here are `init_intra_noar(32)`
plus seeded numpy HWIO weights for the 5x5 context conv (N -> 2N) and the
1x1 entropy-parameter stack (4N -> 10N/3 -> 8N/3 -> 2N), bridged by
`params_from_jax(..., "cheng2020")`.  Bits within 3e-3 relative, pictures
within the 5% relative-RMS floor of tests/parity_utils.py.  The serial
stream round-trips exactly: the decoder's y_hat equals the encoder's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parity_utils import assert_rel_rms
from lssvc_tpu.models.cheng2020 import Cheng2020Anchor as JCheng
from lssvc_tpu.models.init import init_intra_noar as j_init_intra_noar
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models import Cheng2020Anchor, model_architectures
from lssvc_tpu_torch.models.init import init_cheng2020

from torch_threads import share_cores

share_cores()

N = 32


def _jax_params(seed=0):
    """The JAX model's params (numpy): IntraNoAR's and the context and
    entropy-parameter convs at the shapes `cheng2020.py:45-63` reads."""
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in j_init_intra_noar(N=N).items()}

    def conv(name, cin, cout, k):
        std = np.sqrt(2.0 / (cin * k * k + cout * k * k))
        params[f"{name}.weight"] = (rng.normal(size=(k, k, cin, cout))
                                    * std).astype(np.float32)
        params[f"{name}.bias"] = np.full((cout,), 0.01, np.float32)

    conv("context_prediction", N, 2 * N, 5)
    chans = (N * 12 // 3, N * 10 // 3, N * 8 // 3, N * 6 // 3)
    for i in range(3):
        conv(f"entropy_parameters.{2 * i}", chans[i], chans[i + 1], 1)
    return params


@pytest.fixture(scope="module")
def pair():
    jp = _jax_params()
    jm = JCheng({k: jnp.asarray(v) for k, v in jp.items()}, N=N)
    tm = Cheng2020Anchor(params_from_jax(jp, "cheng2020"), device="cpu")
    x = np.random.default_rng(1).random((1, 64, 64, 3)).astype(np.float32)
    return jm, tm, x


def test_forward_matches_jax(pair):
    jm, tm, x = pair
    ref = jm.forward(jnp.asarray(x))
    out = tm.forward(torch.from_numpy(x))
    assert float(out["bit"]) == pytest.approx(float(ref["bit"]), rel=3e-3)
    for k in ("x_hat", "y_hat"):
        assert_rel_rms(out[k].numpy(), np.asarray(ref[k]))
    for k in ("y", "z"):
        assert out["likelihoods"][k].shape == ref["likelihoods"][k].shape


def test_get_rec_only_matches_jax(pair):
    jm, tm, x = pair
    ref = jm.get_rec_only(jnp.asarray(x))
    out = tm.get_rec_only(torch.from_numpy(x))
    for k in ("x_hat", "y_hat"):
        assert_rel_rms(out[k].numpy(), np.asarray(ref[k]))
    # the forward's g_s runs on the same round(y)
    torch.testing.assert_close(out["x_hat"],
                               tm.forward(torch.from_numpy(x))["x_hat"],
                               rtol=0, atol=0)


def test_stream_round_trips_exactly(pair, tmp_path):
    """compress -> decompress: the decoder's y_hat equals the encoder's bit
    for bit; the stream's bits stay near the estimate (the estimate's
    context runs on round(y), the coder's on the decoded latents); and
    encode_decode's file bits are the file's size."""
    _, tm, x = pair
    tm.update(force=True)
    xt = torch.from_numpy(x)
    enc = tm.compress(x=xt)
    dec = tm.decompress(enc["strings"], enc["shape"])
    np.testing.assert_array_equal(dec["y_hat"].numpy(), enc["y_hat"])
    assert dec["x_hat"].shape == (1, 64, 64, 3)
    assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1

    # each latent against its own estimate (chip_smoke's check): z is
    # coded with the EntropyBottleneck's CDFs; y's coder rounds each scale
    # up a table row, so it codes below the estimate with random weights
    lik = tm.forward(xt)["likelihoods"]
    est_y, est_z = (float(-torch.log2(lik[k]).sum()) for k in ("y", "z"))
    real_y, real_z = (8 * len(enc["strings"][i][0]) for i in (0, 1))
    assert abs(real_z - est_z) <= 0.02 * est_z + 64, (real_z, est_z)
    assert 0.75 * est_y <= real_y <= 1.01 * est_y + 64, (real_y, est_y)

    est = float(tm.forward(xt)["bit"])
    res = tm.encode_decode(xt, tmp_path / "c.bin", 64, 64)
    assert res["bit"] == 8 * (tmp_path / "c.bin").stat().st_size
    overhead = 16 * 8 + 2 * 2 * 64
    assert abs(res["bit"] - est) < overhead + 0.1 * est, (res["bit"], est)
    torch.testing.assert_close(res["x_hat"], dec["x_hat"], rtol=0, atol=0)
    with pytest.warns(UserWarning, match="RDO is not supported"):
        tm.encode_decode(xt, rdo=True)


def test_other_slopes_are_refused():
    params = init_cheng2020(torch.Generator().manual_seed(0), N)
    with pytest.raises(NotImplementedError, match="leaky_relu_slope=0.01"):
        Cheng2020Anchor(params, device="cpu", leaky_relu_slope=0.2)


def test_bridge_loads_strict(pair):
    """The bridged JAX params load strict, the port's own init has the
    same keys and shapes, and the registry names the model as the JAX
    package's does."""
    _, tm, _ = pair
    jp = _jax_params()
    tm.load_state_dict(params_from_jax(jp, "cheng2020"), strict=True)
    own = init_cheng2020(torch.Generator().manual_seed(0), N)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert model_architectures["cheng2020-anchor"] is Cheng2020Anchor
    assert tm.N == N
