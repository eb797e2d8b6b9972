"""``cuda_build.launch`` with a stand-in library (no GPU or nvcc needed):
under torch.profiler each call runs inside a range named after its C entry
point, which is how a trace splits device time between ported kernels that
share a template; without a profiler no range is opened, and a non-zero
CUDA error raises either way."""

import types

import pytest
import torch

from clip_ppo_tpu_torch import cuda_build


@pytest.fixture
def fake_lib(monkeypatch):
    calls = []

    def entry(*args):
        calls.append((args, torch._C._autograd._profiler_enabled()))
        return args[-1]  # the error code the test asks for

    libs = {"mlp_stream": types.SimpleNamespace(mlp_stream_launch=entry)}
    monkeypatch.setattr(cuda_build, "build_all", lambda: libs)
    return calls


def test_launch_names_a_profiler_range_after_the_entry_point(fake_lib):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            cuda_build.launch("mlp_stream", "mlp_stream_launch", 7, 0)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("mlp_stream_launch") == 3
    assert fake_lib == [((7, 0), True)] * 3


def test_launch_opens_no_range_without_a_profiler_and_raises_on_error(fake_lib):
    cuda_build.launch("mlp_stream", "mlp_stream_launch", 7, 0)
    assert fake_lib == [((7, 0), False)]
    with pytest.raises(RuntimeError, match="mlp_stream.mlp_stream_launch failed with CUDA error 2"):
        cuda_build.launch("mlp_stream", "mlp_stream_launch", 7, 2)
