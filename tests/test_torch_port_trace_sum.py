"""One rule decides which device records of a torch.profiler trace are
kernels, in every device-time sum of the port's tools and of
``chip_smoke.py``: ``tools/measure.py:is_annotation``. The annotations
PyTorch mirrors onto the device track (``ProfilerStep#1``,
``Optimizer.step#AdamW.step``) span kernels and are left out; a kernel whose
own name holds '#' (PyTorch's lambda-templated elementwise kernels) counts.
One list of synthetic records goes to all three sums through stub profiler
objects; no card is needed."""
import types

import pytest
import torch

import chip_smoke
from dsml_thesis_tpu_torch.tools import measure, variants
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

LAMBDA = ("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
          "::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
          "const::{lambda(float)#1}, std::array<char*, 2ul> >(int, "
          "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
          "::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
          "const::{lambda(float)#1}, std::array<char*, 2ul>)")
# (name, device us, launches): two kernels, two annotations
RECORDS = (
    (LAMBDA, 30.0, 3),
    ("flash_attention_fproj_kernel", 12.0, 2),
    ("ProfilerStep#1", 500.0, 1),
    ("Optimizer.step#AdamW.step", 200.0, 1),
)
KERNEL_US = 42.0


@pytest.mark.parametrize("name,annotation", [
    (LAMBDA, False), ("flash_attention_fproj_kernel", False),
    ("ProfilerStep#1", True), ("Optimizer.step#AdamW.step", True),
    ("Optimizer.zero_grad#AdamW.zero_grad", True)])
def test_is_annotation(name, annotation):
    assert measure.is_annotation(name) is annotation


def _averages():
    """key_averages() records of the RECORDS, on the device track."""
    cuda = types.SimpleNamespace(name="CUDA")
    return [types.SimpleNamespace(key=n, device_type=cuda,
                                  self_device_time_total=us, count=c)
            for n, us, c in RECORDS]


def test_chip_smoke_device_us():
    """chip_smoke.py's sum over the trace's own records."""
    from torch.autograd import DeviceType

    events = [types.SimpleNamespace(
        device_type=lambda: DeviceType.CUDA, name=lambda n=n: n,
        duration_ns=lambda us=us: us * 1e3) for n, us, _ in RECORDS]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert chip_smoke._device_us(prof) == pytest.approx(KERNEL_US)


def test_measure_device_kernels():
    prof = types.SimpleNamespace(key_averages=_averages)
    out = measure._device_kernels(prof)
    assert sorted(out) == sorted([LAMBDA, "flash_attention_fproj_kernel"])
    assert sum(ms for ms, _ in out.values()) == pytest.approx(KERNEL_US / 1e3)


def test_variants_device_kernels_ms(monkeypatch):
    """tools/variants.py's per-kernel sum of one call (a single iteration
    here), with a stub in place of torch.profiler.profile."""

    class Profile:
        def __init__(self, **_kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_a):
            return False

        key_averages = staticmethod(_averages)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    out = variants.device_kernels_ms(lambda: None, iters=1)
    assert len(out) == 2 and not any("#" in k and "lambda" not in k
                                     for k in out)
    assert sum(out.values()) == pytest.approx(KERNEL_US / 1e3)


@pytest.mark.parametrize("name,family", [
    # cuDNN's FFT convolution (fp32 without TF32): complex GEMMs and FFTs
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_"
     "warpsize2x2x1_ffma_aligna8", "convolution (FFT)"),
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>"
     "(float2*, float2*, int, int3, int3, int2, int2)", "convolution (FFT)"),
    # cuDNN's implicit-GEMM convolution passes
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize32x32x8_stage3_warpsize1x2x1", "convolution"),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_tf32f32_f32", "convolution"),
    # cuBLAS's real GEMMs stay linears
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_"
     "warpsize1x4x1_ffma_aligna4", "linear (cuBLAS)"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_tn_align1>"
     "(cutlass_80_simt_sgemm_128x64_8x5_tn_align1::Params)",
     "linear (cuBLAS)"),
])
def test_kernel_families_of_a_video_batch(name, family):
    """Kernel names of a mead-128 video batch's trace (``tools/measure.py
    --video``): the convolutions whose names say GEMM are convolutions."""
    assert measure._family(name) == family
