"""The port's conv + GroupNorm-statistics op and the models that thread the
statistics, against the JAX package on the CPU.

``conv_stats_reference`` is what the wrapper runs on a CPU tensor and what
the CUDA kernel is held against on the card. Here it is held against the JAX
package's ``conv_stats`` with its Pallas kernel in interpret mode, as its own
tests run it (``tests/test_conv_gn.py``); the models run under
``DSML_GN_EPILOGUE=res`` / ``1`` against the JAX models under
``res-interpret`` / ``interpret``.

Tolerances. fp32 op: 1e-4 absolute on y (the same sums in another order), 1e-4
of the largest sum on the statistics. bf16 op: 2e-2 of the output's maximum
(one bf16 rounding of y on each side, of the normalized input too), and the
statistics, sums of those rounded values, 1e-2 of the largest. Models in
fp32: 1e-4 a UNet or first-stage call, as the unflagged tests of the same
models. The whole pipeline and a train step under the flags are in
``test_torch_port_slices.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import autoencoder as jae
from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu.ops import conv_gn as jcg
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.models import autoencoder as tae
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import conv_gn as tcg
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

# flag value on the port's side -> on the JAX side (its interpret-mode twin)
JAX_MODE = {"res": "res-interpret", "1": "interpret"}


def _conv_inputs(seed, b, hh, ww, cin, cout, ksize, skip, prologue):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = r(b, hh, ww, cin) * 2 + 0.5
    a = dict(x=x, w=r(ksize, ksize, cin, cout) * (ksize * ksize * cin) ** -0.5,
             bias=0.5 * r(b, cout))
    if skip:
        a["skip"] = r(b, hh, ww, cout)
    if prologue:
        xf = x.reshape(b, -1, cin)
        a.update(in_stats=(xf.sum(1), (xf * xf).sum(1)),
                 gamma=1 + 0.1 * r(cin), beta=0.1 * r(cin))
    return a


def _both(a, jdt, tdt, **kw):
    """(JAX kernel in interpret mode, the port on the CPU), as float32 numpy
    triples. Statistics and norm parameters stay fp32 on both sides."""
    act = ("x", "w", "skip")
    j = {k: (jnp.asarray(v).astype(jdt) if k in act else
             jax.tree.map(jnp.asarray, v)) for k, v in a.items()}
    want = jcg.conv_stats(j.pop("x"), j.pop("w"), j.pop("bias"),
                          use_pallas=True, interpret=True, **j, **kw)
    t = {k: (torch.from_numpy(v).to(tdt) if k in act else
             jax.tree.map(torch.from_numpy, v)) for k, v in a.items()}
    got = tcg.conv_stats(t.pop("x"), t.pop("w"), t.pop("bias"), **t, **kw)
    return ([np.asarray(o.astype(jnp.float32)) for o in want],
            [o.float().numpy() for o in got])


CASES = {
    "3x3": (2, 8, 8, 32, 64, 3, False, False),
    "3x3-skip": (2, 8, 8, 32, 32, 3, True, False),
    "3x3-norm-skip": (2, 8, 8, 64, 32, 3, True, True),
    "3x3-norm-odd": (1, 7, 5, 32, 48, 3, False, True),
    "1x1-skip": (2, 6, 6, 32, 64, 1, True, False),
    "1x1-norm": (2, 6, 6, 64, 96, 1, False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_conv_stats_reference_matches_jax_kernel_fp32(name):
    want, got = _both(_conv_inputs(0, *CASES[name]), jnp.float32,
                      torch.float32)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, atol=1e-4 * np.abs(w_).max(), rtol=0)


@pytest.mark.parametrize("name", ["3x3-norm-skip", "1x1-skip"])
def test_conv_stats_reference_matches_jax_kernel_bf16(name):
    want, got = _both(_conv_inputs(1, *CASES[name]), jnp.bfloat16,
                      torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0],
                               atol=2e-2 * np.abs(want[0]).max(), rtol=0)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, atol=1e-2 * np.abs(w_).max(), rtol=0)


def test_conv_stats_norm_without_silu_and_eps():
    """The transformer's and the first stage's norms: no SiLU, eps 1e-6."""
    a = _conv_inputs(2, 2, 6, 6, 64, 32, 1, False, True)
    want, got = _both(a, jnp.float32, torch.float32, eps=1e-6, silu_in=False)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    other = _both(a, jnp.float32, torch.float32)[1]
    assert np.abs(other[0] - got[0]).max() > 1e-2   # SiLU does change y


def test_conv_stats_statistics_are_of_the_stored_values():
    """In bf16 the sums are of y as rounded to bf16, bit for bit the sums a
    later statistics pass would take from the stored tensor."""
    a = _conv_inputs(3, 2, 8, 8, 32, 32, 3, True, False)
    t = lambda k: torch.from_numpy(a[k]).bfloat16()
    y, s1, s2 = tcg.conv_stats(t("x"), t("w"), torch.from_numpy(a["bias"]),
                               skip=t("skip"))
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    r1, r2 = tgn.gn_channel_stats_reference(y.reshape(2, -1, 32))
    assert torch.equal(s1, r1) and torch.equal(s2, r2)


def test_conv_stats_border_is_zero_after_the_norm():
    """A tap outside the image reads 0, not the norm of 0: with a large beta
    the two differ in every border pixel and in no interior one."""
    a = _conv_inputs(4, 1, 6, 6, 32, 32, 3, False, True)
    a["beta"] = a["beta"] + 3.0
    t = jax.tree.map(torch.from_numpy, a)
    y, _, _ = tcg.conv_stats(t["x"], t["w"], t["bias"], in_stats=t["in_stats"],
                             gamma=t["gamma"], beta=t["beta"])
    normed = tcg.group_norm_silu_apply(t["x"], *t["in_stats"], t["gamma"],
                                       t["beta"])
    pad_then_norm = torch.nn.functional.conv2d(
        torch.nn.functional.pad(normed.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                value=float(torch.nn.functional.silu(
                                    torch.tensor(3.0)))),
        t["w"].permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + t["bias"][:, None, None]
    diff = (y - pad_then_norm).abs().amax(-1)[0]
    assert diff[1:-1, 1:-1].max() < 1e-4 and diff[0].min() > 1e-2
    want = _both(a, jnp.float32, torch.float32)[0]
    np.testing.assert_allclose(y.numpy(), want[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["3x3-skip", "3x3-norm-skip", "1x1-norm"])
def test_conv_stats_gradients_match_jax(name):
    """Gradients of a scalar of all three outputs with respect to every
    operand, against ``jax.grad`` through the JAX op's custom VJP."""
    a = _conv_inputs(5, *CASES[name])
    rng = np.random.default_rng(6)
    keys = [k for k in ("x", "w", "bias", "skip", "gamma", "beta") if k in a]
    if "in_stats" in a:
        a["s1"], a["s2"] = a.pop("in_stats")
        keys += ["s1", "s2"]
    cout = a["w"].shape[-1]
    gy = rng.standard_normal(a["x"].shape[:3] + (cout,)).astype(np.float32)
    g1, g2 = (0.1 * rng.standard_normal((a["x"].shape[0], cout)
                                        ).astype(np.float32) for _ in range(2))

    def call(fn, d, **kw):
        d = dict(d)
        if "s1" in d:
            d["in_stats"] = (d.pop("s1"), d.pop("s2"))
        return fn(d.pop("x"), d.pop("w"), d.pop("bias"), **d, **kw)

    def jloss(*vals):
        y, s1, s2 = call(jcg.conv_stats, dict(zip(keys, vals)),
                         use_pallas=True, interpret=True)
        return (jnp.sum(y * gy) + jnp.sum(s1 * g1) + jnp.sum(s2 * g2))

    want = jax.grad(jloss, argnums=tuple(range(len(keys))))(
        *(jnp.asarray(a[k]) for k in keys))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in keys]
    y, s1, s2 = call(tcg.conv_stats, dict(zip(keys, leaves)))
    loss = ((y * torch.from_numpy(gy)).sum() + (s1 * torch.from_numpy(g1)).sum()
            + (s2 * torch.from_numpy(g2)).sum())
    got = torch.autograd.grad(loss, leaves)
    for k, g, w_ in zip(keys, got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, err_msg=k,
                                   atol=1e-4 * max(np.abs(w_).max(), 1.0))


def test_conv_stats_function_backward_is_the_plain_versions():
    """The ``Function`` the card uses (kernel forward, backward by autograd of
    the plain version), with the plain version standing in for the launch:
    the same gradients as differentiating the plain version directly, absent
    operands included."""
    a = _conv_inputs(7, 2, 6, 6, 32, 32, 3, True, True)
    t = jax.tree.map(torch.from_numpy, a)
    names = ("x", "w", "bias", "skip", "gamma", "beta")

    def grads(apply):
        leaves = {k: t[k].clone().requires_grad_() for k in names}
        s1, s2 = (s.clone().requires_grad_() for s in t["in_stats"])
        outs = apply(leaves, s1, s2)
        loss = outs[0].square().sum() + outs[1].sum() + 0.1 * outs[2].sum()
        return torch.autograd.grad(loss, [*leaves.values(), s1, s2])

    plain = grads(lambda l, s1, s2: tcg.conv_stats_reference(
        l["x"], l["w"], l["bias"], l["skip"], (s1, s2), l["gamma"], l["beta"]))
    from unittest import mock
    with mock.patch.object(
            tcg, "_launch_conv_stats",
            lambda *args: tuple(o.detach() for o in
                                tcg.conv_stats_reference(*args))):
        fn = grads(lambda l, s1, s2: tcg._ConvStats.apply(
            32, 1e-5, True, l["x"], l["w"], l["bias"], l["skip"], s1, s2,
            l["gamma"], l["beta"]))
        no_skip = tcg._ConvStats.apply(32, 1e-5, True, t["x"].requires_grad_(),
                                       t["w"], t["bias"], None, None, None,
                                       None, None)
        gx, = torch.autograd.grad(no_skip[0].sum(), t["x"])
    for p, f in zip(plain, fn):
        assert torch.allclose(p, f, atol=1e-6)
    assert gx.shape == t["x"].shape


def test_conv_stats_checks_and_narrow_outputs():
    a = _conv_inputs(8, 1, 4, 4, 32, 3, 3, False, True)   # a 3-channel conv
    want, got = _both(a, jnp.float32, torch.float32)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    x, w, bias = (torch.from_numpy(a[k]) for k in ("x", "w", "bias"))
    with pytest.raises(ValueError):
        tcg.conv_stats(x, torch.zeros(2, 2, 32, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError):
        tcg.conv_stats(x, w, bias[:, :2])
    with pytest.raises(ValueError):
        tcg.conv_stats(x, w, bias, skip=torch.zeros(1, 4, 4, 5))
    with pytest.raises(ValueError):
        tcg.conv_stats(x, w, bias, in_stats=(bias, bias))
    assert tcg.conv3x3_stats is tcg.conv_stats


def test_apply_from_stats_is_the_groupnorm_fold():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 5, 64)).astype(np.float32)
    g, b = 1 + 0.1 * rng.standard_normal(64), 0.1 * rng.standard_normal(64)
    xf = x.reshape(2, -1, 64)
    want = np.asarray(jcg.group_norm_silu_apply(
        jnp.asarray(x), jnp.asarray(xf.sum(1)), jnp.asarray((xf * xf).sum(1)),
        jnp.asarray(g, jnp.float32), jnp.asarray(b, jnp.float32)))
    t = torch.from_numpy
    got = tcg.group_norm_silu_apply(t(x), t(xf.sum(1)), t((xf * xf).sum(1)),
                                    t(g).float(), t(b).float())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert tcg.group_norm_silu_apply is tgn.group_norm_silu_from_stats


# --------------------------------------------------------------------------
# blocks and models under the flag
# --------------------------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """(Cin, Cout, K, input norm, skip) of every ``conv_stats`` call the
    port's models make."""
    calls = []
    real = tcg.conv_stats

    def conv_stats(x, w, bias, skip=None, in_stats=None, **kw):
        calls.append((w.shape[2], w.shape[3], w.shape[0],
                      in_stats is not None, skip is not None))
        return real(x, w, bias, skip=skip, in_stats=in_stats, **kw)

    monkeypatch.setattr(tunet, "conv_stats", conv_stats)
    return calls


def _set_mode(monkeypatch, side, mode):
    monkeypatch.setenv("DSML_GN_EPILOGUE",
                       JAX_MODE[mode] if side == "jax" else mode)


def test_gn_epilogue_mode_vocabulary(monkeypatch):
    monkeypatch.delenv("DSML_GN_EPILOGUE", raising=False)
    assert not tunet.gn_epilogue_mode() and not tunet.gn_epilogue_mode(True)
    for mode, (res, full) in {"0": (False, False), "res": (True, False),
                              "1": (True, True), "on": (True, True)}.items():
        monkeypatch.setenv("DSML_GN_EPILOGUE", mode)
        assert (tunet.gn_epilogue_mode(), tunet.gn_epilogue_mode(True)) == \
            (res, full)
    for hook in ("interpret", "res-interpret", "stats"):
        monkeypatch.setenv("DSML_GN_EPILOGUE", hook)
        with pytest.raises(ValueError):
            tunet.gn_epilogue_mode()


@pytest.mark.parametrize("cin,cout,with_stats", [(32, 32, True), (32, 64, True),
                                                 (64, 32, False)])
def test_resblock_matches_jax_under_the_flag(monkeypatch, spy, cin, cout,
                                             with_stats):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    emb = rng.standard_normal((2, 24)).astype(np.float32)
    xf = x.reshape(2, -1, cin)
    st = (xf.sum(1), (xf * xf).sum(1)) if with_stats else None
    jm = junet.ResBlock(cout)
    params = random_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(emb))["params"], rng)
    tm = tunet.ResBlock(cin, 24, cout).eval()
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    _set_mode(monkeypatch, "jax", "res")
    want, want_st = jm.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(emb),
                             in_stats=jax.tree.map(jnp.asarray, st))
    _set_mode(monkeypatch, "torch", "res")
    with torch.no_grad():
        got, got_st = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(emb),
                         None if st is None else tuple(map(torch.from_numpy, st)))
    assert spy == [(cin, cout, 3, with_stats, False), (cout, cout, 3, True, True)]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    for g, w_ in zip(got_st, want_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                   atol=1e-4 * np.abs(w_).max(), rtol=0)
    # the statistics the block hands on are those of its output
    r1, r2 = tgn.gn_channel_stats_reference(
        got.permute(0, 2, 3, 1).reshape(2, -1, cout))
    assert torch.allclose(got_st[0], r1, atol=1e-3)
    assert torch.allclose(got_st[1], r2, atol=1e-3)


UNET_KW = dict(in_channels=9, model_channels=32, out_channels=3,
               num_res_blocks=2, attention_resolutions=(2,),
               channel_mult=(1, 2), num_head_channels=16,
               use_spatial_transformer=True, transformer_depth=1,
               context_dim=48)


@pytest.fixture(scope="module")
def unets():
    rng = np.random.default_rng(11)
    jm = junet.UNetModel(**UNET_KW)
    x = jnp.zeros((2, 8, 8, 9))
    params = random_params(
        jm.init(jax.random.PRNGKey(0), x, jnp.zeros((2,), jnp.int32),
                jnp.zeros((2, 1, 48)))["params"], rng)
    tm = tunet.UNetModel(**UNET_KW)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


def _unet_inputs(seed, pairs):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 9)).astype(np.float32),
            np.array([3, 77], np.int32),
            rng.standard_normal((4 if pairs else 2, 1, 48)).astype(np.float32))


# conv_stats calls of the [1, 2] UNet above: 12 ResBlocks (4 down, 2 middle,
# 6 up) of two convs; under 1 also conv_in, the 6 transformers' proj_in and
# proj_out, and conv_out (3 output channels: the op's plain conv)
UNET_CONVS = {"res": 24, "1": 24 + 1 + 12 + 1}


@pytest.mark.parametrize("pairs", [False, True], ids=["plain", "cfg-pairs"])
@pytest.mark.parametrize("mode", ["res", "1"])
def test_unet_matches_jax_under_the_flag(unets, monkeypatch, spy, mode, pairs):
    jm, params, tm = unets
    x, t, ctx = _unet_inputs(12, pairs)
    _set_mode(monkeypatch, "jax", mode)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx),
                               cfg_pairs=pairs))
    _set_mode(monkeypatch, "torch", mode)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(ctx), cfg_pairs=pairs).numpy()
        monkeypatch.delenv("DSML_GN_EPILOGUE")
        unfused = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(ctx), cfg_pairs=pairs).numpy()
    assert len(spy) == UNET_CONVS[mode]
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, unfused, atol=1e-4, rtol=0)


DDCONFIG = dict(double_z=False, z_channels=3, resolution=16, in_channels=3,
                out_ch=3, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(8,), dropout=0.0)


@pytest.fixture(scope="module")
def first_stage():
    rng = np.random.default_rng(13)
    jm = jae.VQModel(ddconfig=DDCONFIG, n_embed=32, embed_dim=3)
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))["params"],
        rng)
    tm = tae.VQModel(ddconfig=DDCONFIG, n_embed=32, embed_dim=3)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("mode", ["res", "1"])
def test_first_stage_matches_jax_under_the_flag(first_stage, monkeypatch, spy,
                                                mode):
    jm, params, tm = first_stage
    rng = np.random.default_rng(14)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    _set_mode(monkeypatch, "jax", mode)
    want_z = np.asarray(jm.apply({"params": params}, jnp.asarray(img),
                                 method=jm.encode))
    want_img = np.asarray(jm.apply({"params": params}, jnp.asarray(z), True,
                                   method=jm.decode))
    _set_mode(monkeypatch, "torch", mode)
    with torch.no_grad():
        got_z = tm.encode(torch.from_numpy(img)).numpy()
        n_encode = len(spy)
        got_img = tm.decode(torch.from_numpy(z),
                            force_not_quantize=True).numpy()
    # ResnetBlocks: 2 + 2 mid in the encoder, 4 + 2 mid in the decoder, two
    # convs each; under 1 also the stems and each AttnBlock's qkv (+ proj_out
    # where a norm follows)
    assert n_encode >= 8 and len(spy) - n_encode >= 12
    if mode == "res":
        assert (n_encode, len(spy)) == (8, 20)
        assert all(k == 3 for _, _, k, _, _ in spy)
    else:
        assert any(k == 1 and cout == 3 * cin for cin, cout, k, _, _ in spy)
    np.testing.assert_allclose(got_z, want_z, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_img, want_img, atol=1e-4, rtol=0)


def test_flags_leave_the_state_dict_alone(unets, first_stage, monkeypatch):
    """No parameter is created, renamed or dropped by either flag, so
    ``convert.py`` needs no new mapping: the JAX trees load under every flag
    with ``strict=True``, and the keys are those of the unflagged modules."""
    _, uparams, tm = unets
    _, fparams, fm = first_stage
    keys = (list(tm.state_dict()), list(fm.state_dict()))
    for mode in ("res", "1"):
        monkeypatch.setenv("DSML_GN_EPILOGUE", mode)
        monkeypatch.setenv("DSML_FLASH_STREAMING", "1")
        u, f = tunet.UNetModel(**UNET_KW), tae.VQModel(
            ddconfig=DDCONFIG, n_embed=32, embed_dim=3)
        assert (list(u.state_dict()), list(f.state_dict())) == keys
        u.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, uparams)),
                          strict=True)
        f.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, fparams)),
                          strict=True)
