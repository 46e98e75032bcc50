"""The program's spans (``utils/profiling.py`` ``span``) on the CPU: off
without a profiler (no totals, no mark); under ``torch.profiler`` one step of
a tiny ``nerfacto-tpu`` (tri Fourier field, the fused wrappers' plain paths)
and one batch draw of its ``InMemoryDataManager`` give every span of the
training step, the draw and the wrappers, nested in the profile as in the
totals, with the self times and counts a step implies; the totals reset on
a new session; threads lose no count; ``trace`` writes ``trace.json`` and
``spans.json``. About 10 s."""

import json
import sys
import threading
from pathlib import Path

import pytest
import torch

import nerf_kbs_tpu_torch.methods  # noqa: F401  (registers the methods)
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.ops import fused_field as ff
from nerf_kbs_tpu_torch.utils import profiling

# span: (its parents a step {parent: count}; '' is none)
SPANS = {
    "train_step": {"": 1},
    "train_step.h2d": {"train_step": 1},
    "train_step.forward": {"train_step": 1},
    "train_step.loss": {"train_step": 1},
    "train_step.backward": {"train_step": 1},
    "train_step.optimizer": {"train_step": 1},
    "next_train": {"": 1},
    "next_train.sample": {"next_train": 1},
    # A twice (two proposal fields) and B in the forward, C twice and D in
    # the backward
    "fused_field": {"train_step.forward": 3, "train_step.backward": 3},
    # the interlevel loss's two bound sums, in its backward
    "segment_sum": {"train_step.backward": 2},
}
PHASES = ("train_step.h2d", "train_step.forward", "train_step.loss", "train_step.backward",
          "train_step.optimizer")
TINY = {"fourier_num_levels": "2", "fourier_features_per_level": "8",
        "proposal_fourier_features_per_level": "4", "proposal_num_levels": "2",
        "proposal_max_res": "16,32", "num_proposal_samples_per_ray": "16,8",
        "num_nerf_samples_per_ray": "8", "hidden_dim": "16", "hidden_dim_color": "16",
        "proposal_hidden_dim": "8", "max_res": "32", "appearance_embedding_dim": "0",
        "interlevel_ray_fraction": "0.5"}


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    scene = tsk.write_dataset(root / "scene", n_frames=4, h=24, w=80, seed=0)
    overrides = {"dataparser.data_dir": str(scene), "dataparser.first_frame": "0",
                 "dataparser.last_frame": "4", "dataparser.image_height": "24",
                 "dataparser.image_width": "80", "dataparser.train_split_fraction": "0.75",
                 "dataparser.use_depth": "true", "datamanager.train_num_rays_per_batch": "64",
                 "datamanager.num_workers": "2", "trainer.output_dir": str(root / "out"),
                 **{f"model.{k}": v for k, v in TINY.items()}}
    spec = tcli.apply_overrides(tcli.method_registry["nerfacto-tpu"](), overrides)
    tr = tcli.build_trainer(spec, device="cpu")
    tr.train_step(tr.dm.next_train(tr.step))  # first-call costs outside the traced step
    return tr


def _step(tr):
    return tr.train_step(tr.dm.next_train(tr.step))


@pytest.fixture(scope="module")
def traced(trainer):
    """(span_totals, the profile's events) of one draw and one step."""
    with _profile() as prof:
        _step(trainer)
    return profiling.span_totals(), prof.events()


def test_off_without_a_profiler(trainer, monkeypatch):
    entered = []

    class Mark:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Mark)
    before = profiling.span_totals()
    _step(trainer)
    assert profiling.span_totals() == before
    assert entered == []
    # one shared context, whatever the span
    assert profiling.span("train_step") is profiling.span("next_train", torch.device("cpu"))


def test_a_step_gives_every_span_nested(traced):
    totals, events = traced
    assert set(totals) == set(SPANS)
    for name, parents in SPANS.items():
        assert totals[name]["parents"] == parents, name
        assert totals[name]["count"] == sum(parents.values()), name
        assert "device_ms" not in totals[name]  # no CUDA device

    # in the profile: each nkt.* event lies inside one of its parent's, on
    # the parent's thread
    marks = [e for e in events if e.name.startswith("nkt.")]
    assert sorted(m.name[4:] for m in marks) == sorted(
        n for n, p in SPANS.items() for _ in range(sum(p.values())))
    for m in marks:
        parents = set(SPANS[m.name[4:]]) - {""}
        if not parents:
            continue
        assert any(p.name[4:] in parents and p.thread == m.thread
                   and p.time_range.start <= m.time_range.start
                   and m.time_range.end <= p.time_range.end for p in marks), m.name


def test_self_time_is_the_duration_less_the_children(traced):
    totals, _ = traced
    host = {n: t["host_ns"] for n, t in totals.items()}
    selfs = {n: t["self_ns"] for n, t in totals.items()}
    assert selfs["train_step"] == host["train_step"] - sum(host[p] for p in PHASES)
    assert selfs["next_train"] == host["next_train"] - host["next_train.sample"]
    # every wrapper span runs in the forward or the backward
    assert selfs["train_step.forward"] + selfs["train_step.backward"] == (
        host["train_step.forward"] + host["train_step.backward"] - host["fused_field"]
        - host["segment_sum"])
    for leaf in ("train_step.h2d", "train_step.loss", "train_step.optimizer",
                 "next_train.sample", "fused_field", "segment_sum"):
        assert selfs[leaf] == host[leaf] > 0, leaf
    assert sum(host[p] for p in PHASES) <= host["train_step"]
    assert all(0 <= s <= host[n] for n, s in selfs.items())


def test_totals_reset_on_a_new_session(trainer):
    with _profile():
        _step(trainer)
    # a session after untraced work holds its own spans only
    trainer.dm.next_train(trainer.step)
    with _profile():
        trainer.dm.next_train(trainer.step)
    draw = {"next_train": 1, "next_train.sample": 1}
    assert {n: t["count"] for n, t in profiling.span_totals().items()} == draw
    # so does a session right after a reading of the totals
    with _profile():
        trainer.dm.next_train(trainer.step)
    assert {n: t["count"] for n, t in profiling.span_totals().items()} == draw


def test_threads_lose_no_count():
    """Two threads call a fused wrapper at once, many times, with the
    interpreter switching threads as often as it can."""
    g = torch.Generator().manual_seed(0)
    spec = ff.FusedMLPSpec(h_freqs=4, layer_dims=(8, 8, 2), bf16=False, basis="tri")
    x, B = torch.rand(3, 16, generator=g), torch.randn(3, 4, generator=g)
    ws = [torch.randn(8, 8, generator=g), torch.randn(8, 2, generator=g)]
    bs = [torch.zeros(8), torch.zeros(2)]
    calls = 400
    start = threading.Barrier(2)

    def work():
        start.wait(timeout=30)
        with profiling.span(f"thread.{threading.get_ident()}"):
            for _ in range(calls):
                ff.fourier_mlp(spec, x, B, ws, bs)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=work) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    totals = profiling.span_totals()
    assert totals["fused_field"]["count"] == 2 * calls
    outer = {f"thread.{t.ident}" for t in threads}
    assert totals["fused_field"]["parents"] == {n: calls for n in outer}
    assert sum(totals[n]["host_ns"] for n in outer) >= totals["fused_field"]["host_ns"]


def test_trace_writes_the_chrome_trace_and_the_span_totals(trainer, tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as d:
        _step(trainer)
    names = {e.get("name") for e in json.loads((Path(d) / "trace.json").read_text())[
        "traceEvents"]}
    assert {f"nkt.{n}" for n in SPANS} <= names
    spans = json.loads((Path(d) / "spans.json").read_text())
    assert spans == profiling.span_totals()
    assert set(spans) == set(SPANS) and spans["train_step"]["count"] == 1


@pytest.mark.cuda
def test_device_spans_time_the_stream():
    """On a card: a span given the device times its stream's work with a
    pair of CUDA events (here: the sum of the inner pairs' times, and the
    few microseconds between them and the span's); one not given it has no
    device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    pairs = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(40):
            with profiling.span("work", dev):
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
                for _ in range(5):
                    a = (a @ a).tanh_()
                pair[1].record()
                pairs.append(pair)
            with profiling.span("host"):
                pass
        torch.cuda.synchronize()
        totals = profiling.span_totals()
    inner = sum(s.elapsed_time(e) for s, e in pairs)
    assert totals["work"]["count"] == 40 and "device_ms" not in totals["host"]
    assert inner * 0.999 <= totals["work"]["device_ms"] <= inner * 1.1 + 1.0
