"""The host path of the fp32 attention wrappers, on the CPU.

Held here: the fp32 backward entries get the arguments their C signatures
declare, at D = 512 and D = 32; the split-head and streaming forwards
launch without the autograd ``Function`` when there is no gradient to
track; and the plain forwards agree with the JAX kernels (interpret mode) at
the Nk < Nq < 64 shape the card's kernels phase adds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


class _OnCard(torch.Tensor):
    """A tensor that says it lies on a CUDA device (the CPU tests have
    none)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


class _Entry:
    """A C entry that records its arguments and reports a launch."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("shape", [(2, 1, 333, 333), (16, 1, 1024, 1024)])
def test_the_backward_calls_its_entry_by_its_signature(streaming, shape,
                                                       monkeypatch):
    """fp32 at D = 512 and 32: the entry gets as many arguments as
    ``_build.SIGNATURES`` declares for it, the head count, lengths and
    width in their places and the stream last."""
    for kernel in ("flash_attention_bwd", "flash_attention_streaming_bwd"):
        monkeypatch.setitem(tatt.LAUNCHES, kernel, 0)   # restored after
    entry = _Entry()
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"__getattr__": lambda self, name: entry})())
    monkeypatch.setattr(tatt, "current_stream", lambda t: 7)
    empty = torch.empty   # scratch on the host: the CPU tests have no card
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        empty(*a, **kw))
    b, h, n, _ = shape
    name = "dsml_flash_attention_" + ("streaming_bwd" if streaming
                                      else "bwd") + "_f32"
    for d in (512, 32):
        t = torch.zeros(b, h, n, d).as_subclass(_OnCard)
        lse = torch.zeros(b * h * n).as_subclass(_OnCard)
        if streaming:
            tatt.flash_attention_streaming_bwd(t, t, t, t, t, 0.1)
        else:
            tatt.flash_attention_bwd(t, t, t, t, lse, t, 0.1)
        args = entry.calls[-1]
        assert len(args) == len(_build.SIGNATURES[name])
        assert args[10:14] == (b * h, n, n, d) and args[-1] == 7
    assert tatt.LAUNCHES[name.removeprefix("dsml_").removesuffix("_f32")] == 2


@pytest.mark.parametrize("streaming", [False, True])
def test_a_forward_without_gradient_skips_the_function(streaming,
                                                       monkeypatch):
    """On the card and with nothing to differentiate, the split-head and
    streaming forwards launch their kernel directly (one count each); with a
    gradient to track they go through their autograd ``Function``."""
    launched = []
    if streaming:
        monkeypatch.setattr(tatt, "_launch_streaming_forward",
                            lambda q, k, v, s: launched.append(s) or q)
        fn, function = tatt.flash_attention_streaming, tatt._StreamingAttention
    else:
        monkeypatch.setattr(tatt, "_launch_flash_forward",
                            lambda q, k, v, s, lse: launched.append(s)
                            or (q, None))
        fn, function = tatt.flash_attention, tatt._FlashAttention
    used = []
    monkeypatch.setattr(function, "apply",
                        lambda *a: used.append(a) or a[0])
    q = torch.zeros(2, 3, 64, 32).as_subclass(_OnCard)
    assert fn(q, q, q) is q and len(launched) == 1 and not used
    with torch.no_grad():
        fn(q.requires_grad_(), q, q)
    assert len(launched) == 2 and not used
    fn(q, q, q)
    assert len(used) == 1 and len(launched) == 2
    cpu = torch.zeros(2, 3, 64, 32)
    fn(cpu, cpu, cpu)   # the CPU keeps the Function (its plain version)
    assert len(used) == 2


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_plain_forwards_match_jax_kernels_inside_one_key_tile():
    """Rows 2 and 4 in fp32 at D = 32, Nq = 60 against Nk = 50 keys (one
    key tile each side): the plain versions against the JAX split-head and
    streaming kernels in interpret mode."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 3, n, 32)).astype(np.float32)
               for n in (60, 50, 50))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(tatt.attention_reference(tq, tk, tv),
           jatt.flash_attention(jq, jk, jv, block_q=32, interpret=True))
    _close(tatt.streaming_attention_reference(tq, tk, tv),
           jatt.flash_attention_streaming(jq, jk, jv, block_q=32, block_k=16,
                                          interpret=True))
