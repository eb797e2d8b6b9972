"""The port's TensorBoard reader and robustness metrics against tensorboard's
``EventAccumulator`` and the JAX package's metrics (which read through it and
compute with pandas), on logs written by both packages' writers.

The reader must return what ``EventAccumulator`` returns: the same tags, and
per tag the same (wall time, step, value) scalars and text tensors, past the
10,000-scalar reservoir, across a resumed run's second event file, and under
both of tensorboard's purge rules (``SessionLog.START`` with a file version of
2, the by-tag out-of-order rule without one), stopping where a record is cut
short or fails its CRC. The metrics are compared on the same run
directories: the RI columns to rtol 1e-12 (pandas sums each rolling window
as a running, compensated sum, the port each window on its own: they differ
in the last bits), everything else exactly; the plotting CLIs must save the
files the JAX CLIs save.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.compat.proto import event_pb2, summary_pb2

from clip_ppo_tpu import metrics as jm
from clip_ppo_tpu.io.tb_writer import SummaryWriter as JaxWriter
from clip_ppo_tpu.metrics import compare_algorithm_disturbances as jcad
from clip_ppo_tpu.metrics import compare_algorithms as jca
from clip_ppo_tpu.metrics import evaluate_algorithm as jea
from clip_ppo_tpu_torch import metrics as tm
from clip_ppo_tpu_torch.io import tb_reader
from clip_ppo_tpu_torch.io.tb_writer import SummaryWriter as PortWriter
from clip_ppo_tpu_torch.io.tb_writer import tfrecord
from clip_ppo_tpu_torch.metrics import calculate_metrics as tcm
from clip_ppo_tpu_torch.metrics import compare_algorithm_disturbances as tcad
from clip_ppo_tpu_torch.metrics import compare_algorithms as tca
from clip_ppo_tpu_torch.metrics import evaluate_algorithm as tea

WRITERS = {"jax": JaxWriter, "port": PortWriter}


def _write(writer, path, returns, severity=None, steps=None, tag="charts/episodic_return",
           lengths=True):
    w = WRITERS[writer](str(path))
    steps = steps if steps is not None else [128 * (i + 1) for i in range(len(returns))]
    if severity is not None:
        w.add_text("config/disturbance_severity", severity)
    w.add_text("hyperparameters", "|param|value|\n|-|-|\n|seed|1|")
    for i, (s, r) in enumerate(zip(steps, returns)):
        w.add_scalar(tag, float(r), s)
        if lengths:
            w.add_scalar("charts/episodic_length", 10 + i % 7, s)
        if i % 50 == 0:
            w.add_scalar("charts/SPS", 1000 + i, s)
    w.close()
    return str(path)


def _assert_same(path):
    """The port's reader returns what EventAccumulator returns."""
    want = EventAccumulator(path)
    want.Reload()
    got = tb_reader.EventAccumulator(path).Reload()
    assert got.Tags() == want.Tags()
    for tag in want.Tags()["scalars"]:
        assert [(e.wall_time, e.step, e.value) for e in got.Scalars(tag)] == \
            [(e.wall_time, e.step, e.value) for e in want.Scalars(tag)], tag
    for tag in want.Tags()["tensors"]:
        assert [(e.wall_time, e.step, e.tensor_proto.dtype, list(e.tensor_proto.string_val))
                for e in got.Tensors(tag)] == \
            [(e.wall_time, e.step, e.tensor_proto.dtype, list(e.tensor_proto.string_val))
             for e in want.Tensors(tag)], tag
    return got


@pytest.mark.parametrize("writer", WRITERS)
def test_reader_matches_tensorboard_past_the_reservoir(tmp_path, writer):
    rng = np.random.RandomState(0)
    run = _write(writer, tmp_path / "run", rng.rand(10_600), "HARD")
    got = _assert_same(run)
    assert len(got.Scalars("charts/episodic_return")) == 10_000  # a sample, last item kept
    assert got.Scalars("charts/episodic_return")[-1].step == 128 * 10_600
    assert got.Tensors("config/disturbance_severity/text_summary")[0].tensor_proto.string_val \
        == [b"HARD"]


@pytest.mark.parametrize("writer", WRITERS)
def test_reader_matches_tensorboard_across_a_resume(tmp_path, writer):
    """A run resumed from a checkpoint writes a second event file whose steps
    start below the first file's last ones."""
    rng = np.random.RandomState(1)
    run = tmp_path / "run"
    _write(writer, run, rng.rand(300), "CLEAN")
    _write(writer, run, rng.rand(200), steps=[128 * (i + 151) for i in range(200)])
    assert len([f for f in os.listdir(run) if "tfevents" in f]) == 2
    got = _assert_same(str(run))
    assert len(got.Scalars("charts/episodic_return")) == 500  # file version 2: nothing purged


def _framed(events) -> bytes:
    return b"".join(tfrecord(e.SerializeToString()) for e in events)


def _scalar_event(step, tag, value, wall):
    return event_pb2.Event(wall_time=wall, step=step, summary=summary_pb2.Summary(
        value=[summary_pb2.Summary.Value(tag=tag, simple_value=value)]))


def _purge_log(kind: str) -> bytes:
    events = []
    if kind != "no file version":
        events.append(event_pb2.Event(wall_time=1.0, file_version="brain.Event:2"))
    for s in range(10):
        events.append(_scalar_event(s, "a", s * 0.5, 2.0 + s))
        events.append(_scalar_event(s, "b", -s * 0.25, 2.0 + s))
    if kind == "session start":
        events.append(event_pb2.Event(wall_time=20.0, step=4, session_log=event_pb2.SessionLog(
            status=event_pb2.SessionLog.START)))
    events.append(_scalar_event(4, "a", 9.0, 21.0))  # a step that goes back, for tag "a" only
    events.append(_scalar_event(5, "b", 7.0, 22.0))
    return _framed(events)


@pytest.mark.parametrize("kind", ["no file version", "session start", "file version 2"])
def test_reader_purges_like_tensorboard(tmp_path, kind):
    path = tmp_path / "events.out.tfevents.1.host"
    path.write_bytes(_purge_log(kind))
    got = _assert_same(str(tmp_path))
    steps = {tag: [e.step for e in got.Scalars(tag)] for tag in ("a", "b")}
    if kind == "no file version":  # by tag: "a" loses steps 4..9, then "b" loses 5..9
        assert steps == {"a": [0, 1, 2, 3, 4], "b": [0, 1, 2, 3, 4, 5]}
    elif kind == "session start":  # every tag loses steps 4..9
        assert steps == {"a": [0, 1, 2, 3, 4], "b": [0, 1, 2, 3, 5]}
    else:
        assert len(steps["a"]) == 11 and len(steps["b"]) == 11


@pytest.mark.parametrize("damage", ["cut short", "payload crc", "length crc"])
def test_reader_stops_where_tensorboard_stops(tmp_path, damage):
    good = _framed([event_pb2.Event(wall_time=1.0, file_version="brain.Event:2")]
                   + [_scalar_event(s, "a", float(s), 2.0 + s) for s in range(5)])
    bad = bytearray(tfrecord(_scalar_event(5, "a", 5.0, 7.0).SerializeToString()))
    if damage == "cut short":
        bad = bad[:-3]
    elif damage == "payload crc":
        bad[-1] ^= 0xFF
    else:
        bad[8] ^= 0xFF
    tail = tfrecord(_scalar_event(6, "a", 6.0, 8.0).SerializeToString())
    (tmp_path / "events.out.tfevents.1.host").write_bytes(good + bytes(bad) + tail)
    got = _assert_same(str(tmp_path))
    assert [e.step for e in got.Scalars("a")] == [0, 1, 2, 3, 4]


def test_reload_reads_what_was_appended(tmp_path):
    path = tmp_path / "events.out.tfevents.1.host"
    head = _framed([event_pb2.Event(wall_time=1.0, file_version="brain.Event:2")]
                   + [_scalar_event(s, "a", float(s), 2.0 + s) for s in range(3)])
    more = tfrecord(_scalar_event(3, "a", 3.0, 5.0).SerializeToString())
    path.write_bytes(head + more[:10])  # the last record half written
    want, got = EventAccumulator(str(tmp_path)), tb_reader.EventAccumulator(str(tmp_path))
    want.Reload()
    got.Reload()
    assert [e.step for e in got.Scalars("a")] == [e.step for e in want.Scalars("a")] == [0, 1, 2]
    path.write_bytes(head + more)
    want.Reload()
    got.Reload()
    assert [e.step for e in got.Scalars("a")] == [e.step for e in want.Scalars("a")] == [0, 1, 2, 3]


# -- the metrics ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Clean and disturbed runs of unequal lengths, each written by one of the
    two packages' writers, the clean one past the 10,000-scalar reservoir; the
    clean returns dip below the RI's 0.1 floor so that the fill rules act."""
    root = tmp_path_factory.mktemp("pair")
    rng = np.random.RandomState(2)
    clean = rng.rand(10_400)
    clean[:80] *= 0.05  # below the floor at the start (the back-fill)
    clean[3000:3200] *= 0.02  # and in the middle (the forward fill)
    disturbed = 0.6 * rng.rand(9_700)
    return (_write("jax", root / "clean", clean, "CLEAN"),
            _write("port", root / "hard", disturbed, "HARD"))


def test_robustness_index_matches_jax(pair, capsys):
    clean, hard = pair
    want = jm.compute_robustness_index_over_time(clean, hard)
    jout = capsys.readouterr().out
    got = tm.compute_robustness_index_over_time(clean, hard)
    assert capsys.readouterr().out == jout  # the same two lines
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["timestep"], want["timestep"].to_numpy())
    for col in ("clean_return", "disturbed_return", "robustness_index"):
        np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=1e-12, atol=0)
    assert len(got["timestep"]) == 9_700  # the shorter run
    assert (got["clean_return"] <= 0.1).any()  # rows the fill rules fill
    np.testing.assert_allclose(tm.compute_robustness_index(clean, hard),
                               jm.compute_robustness_index(clean, hard), rtol=1e-12)


def test_run_readers_and_rates_match_jax(pair):
    for run in pair:
        assert tm.load_tensorboard_run(run) == jm.load_tensorboard_run(run)
        assert tm.get_disturbance_severity(run).value == jm.get_disturbance_severity(run).value
        ts, ret, _ = tm.load_tensorboard_run(run)
        assert tm.compute_auc_metric(ts, ret) == jm.compute_auc_metric(ts, ret)
        assert tm.compute_success_rate(run, 0.5) == jm.compute_success_rate(run, 0.5)
        assert tm.compute_final_success_rate(run) == jm.compute_final_success_rate(run)


@pytest.mark.parametrize("tag", ["episodic_return", "charts/returns"])
def test_tag_fallbacks_match_jax(tmp_path, tag):
    run = _write("port", tmp_path / "run", [0.0, 1.0, 0.5], "MILD", tag=tag, lengths=False)
    assert tm.load_tensorboard_run(run) == jm.load_tensorboard_run(run)
    assert tm.load_tensorboard_run(run)[2] == []
    empty = _write("port", tmp_path / "none", [1.0], tag="charts/other")
    for fn in (tm.load_tensorboard_run, jm.load_tensorboard_run, tm.get_disturbance_severity,
               jm.get_disturbance_severity):
        with pytest.raises(ValueError):
            fn(empty)


@pytest.mark.parametrize("ts,ret", [
    ([], []), ([5], [1.0]), ([3, 3], [1.0, 2.0]), ([0, 10, 15, 40], [0.0, 1.0, 0.5, 0.25]),
])
def test_auc_matches_jax(ts, ret):
    assert tm.compute_auc_metric(ts, ret) == jm.compute_auc_metric(ts, ret)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32), min_size=1, max_size=200),
       st.integers(1, 60))
def test_rolling_mean_matches_pandas(values, window):
    want = pd.Series(values).rolling(window=window, min_periods=1).mean().to_numpy()
    got = tcm.rolling_mean(values, window)
    scale = max(abs(v) for v in values)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.none(), st.floats(-5, 5, allow_nan=False)), min_size=1,
                max_size=40))
def test_fill_matches_pandas(values):
    ri = np.array([np.nan if v is None else v for v in values], dtype=np.float64)
    want = pd.Series(ri).ffill().bfill().fillna(0).to_numpy()
    np.testing.assert_array_equal(tcm._fill(ri), want)


# -- the plotting CLIs ---------------------------------------------------------------


def _plot_runs(root):
    rng = np.random.RandomState(3)
    runs = {name: _write("port", root / name, rng.rand(120) * scale, sev)
            for name, sev, scale in (("a_clean", "CLEAN", 1.0), ("a_hard", "HARD", 0.7),
                                     ("a_severe", "SEVERE", 0.4), ("b_clean", "CLEAN", 0.9),
                                     ("b_hard", "HARD", 0.5))}
    return runs


@pytest.mark.parametrize("cli", ["compare_algorithm_disturbances", "compare_algorithms",
                                 "evaluate_algorithm"])
def test_plot_clis_save_the_files_jax_saves(tmp_path, monkeypatch, cli):
    runs = _plot_runs(tmp_path)
    argv = {
        "compare_algorithm_disturbances": [
            "--algorithm-name", "CLIP-PPO", "--clean-run-path", runs["a_clean"],
            "--disturbance-runs", runs["a_hard"], runs["a_severe"]],
        "compare_algorithms": [
            # the flag parser splits a tuple's values at commas, so each
            # spec names one disturbed run here
            "--algorithms", f"A:{runs['a_clean']}:{runs['a_hard']}",
            f"B:{runs['b_clean']}:{runs['b_hard']}", f"C:{runs['a_clean']}:{runs['a_severe']}"],
        "evaluate_algorithm": ["--clean-run-path", runs["a_clean"],
                               "--disturbed-run-path", runs["a_hard"]],
    }[cli]
    jax_mod = {"compare_algorithm_disturbances": jcad, "compare_algorithms": jca,
               "evaluate_algorithm": jea}[cli]
    port_mod = {"compare_algorithm_disturbances": tcad, "compare_algorithms": tca,
                "evaluate_algorithm": tea}[cli]
    monkeypatch.setattr(sys, "argv", [cli, *argv, "--save-dir", str(tmp_path / "jax")])
    jax_mod.main()
    saved = port_mod.main([*argv, "--save-dir", str(tmp_path / "port")])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in saved) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        assert (tmp_path / "port" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plotting_needs_matplotlib_only_where_it_draws(tmp_path, monkeypatch):
    runs = _plot_runs(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = tea.EvaluationConfig(clean_run_path=runs["a_clean"], disturbed_run_path=runs["a_hard"],
                               save_dir=str(tmp_path / "plots"))
    with pytest.raises(ImportError):
        tea.plot_auc_comparison(cfg)
    assert np.isfinite(tm.compute_robustness_index(runs["a_clean"], runs["a_hard"]))
