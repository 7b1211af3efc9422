"""The port's spans (spring_tpu_torch/utils/spans.py): the recorder's
bound, parents and threads; a PE compress on the CPU whose stage spans
tile it and sum to LAST_STAGE_SECONDS, with one codec span a member and
one flush span a flush; the PE id check's span and pattern flag, its
archives read back (a second compress, the last pair off the pattern);
the spans' clock against torch.profiler's, on the CPU and (``cuda`` in
the name, skipped without a card) on the card.
No JAX: ``--noconftest -k cuda`` runs the card's case on the GPU
machine."""
import collections
import filecmp
import re
import sys
import threading
import time

import pytest
import torch

from spring_tpu_torch import api
from spring_tpu_torch.io.container import ArchiveReader
from spring_tpu_torch.pipeline import short_mode
from spring_tpu_torch.reorder import engine
from spring_tpu_torch.utils import spans, synth


@pytest.fixture
def fresh(monkeypatch):
    """An empty buffer of the recorder's size, this thread's context
    restored after the test."""
    monkeypatch.setattr(spans, "_buf",
                        collections.deque(maxlen=spans.MAXLEN))
    ctx = spans.context()
    yield
    spans.adopt(ctx)


def test_buffer_keeps_the_newest_maxlen_spans(fresh):
    for i in range(spans.MAXLEN + 5):
        spans.record("s", "io", i, i + 1)
    got = spans.spans()
    assert len(got) == spans.MAXLEN
    assert [s.start_ns for s in got[:2]] == [5, 6]
    assert got[-1].start_ns == spans.MAXLEN + 4
    got.clear()                          # a copy: the buffer keeps them
    assert len(spans.spans()) == spans.MAXLEN


def test_children_name_the_stage_and_compress_that_caused_them(fresh):
    spans.begin_compress()
    compress, stage = spans.context()
    spans.record("flush", "reorder", 1, 2)
    seen = []

    def worker(ctx):
        spans.adopt(ctx)
        spans.record("codec", "codecs", 3, 4, family="quality")
        seen.append(spans.context())
    t = threading.Thread(target=worker, args=(spans.context(),))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    spans.close_stage("reorder_run", "reorder", 0, 5)
    assert spans.context()[0] == compress
    assert spans.context()[1] != stage           # the next stage is open
    spans.record("codec", "codecs", 6, 7, ctx=seen[0], family="seq")
    flush, codec, run_, late = spans.spans()
    assert run_.id == stage and run_.parent is None
    assert (flush.parent, codec.parent, late.parent) == (stage,) * 3
    assert {s.compress for s in (flush, codec, run_, late)} == {compress}
    assert codec.thread != flush.thread == run_.thread
    assert codec.attrs == {"family": "quality"}
    spans.begin_compress()
    assert spans.context()[0] == compress + 1


def test_threads_lose_no_span_and_share_no_id(fresh):
    """More threads than cores, switching often: every span is kept, the
    ids are unique and each thread's stages follow its own context."""
    n_threads, per = 24, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            spans.begin_compress()
            for i in range(per):
                spans.record("codec", "codecs", i, i + 1)
                if i % 50 == 49:
                    spans.close_stage("stage", "io", i, i + 1)
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    got = spans.spans()
    assert len(got) == n_threads * (per + per // 50)
    assert len({s.id for s in got}) == len(got)
    by_thread = collections.defaultdict(list)
    for s in got:
        by_thread[s.thread].append(s)
    assert len(by_thread) == n_threads
    for mine in by_thread.values():
        assert len({s.compress for s in mine}) == 1
        stages = [s for s in mine if s.parent is None]
        assert len(stages) == per // 50
        kids = collections.Counter(s.parent for s in mine
                                   if s.parent is not None)
        assert list(kids.values()) == [50] * (per // 50)
        assert set(kids) == {s.id for s in stages}


@pytest.fixture(scope="module")
def pe_compress(tmp_path_factory):
    """One lossless PE compress on the CPU: its spans, counters and
    archive members."""
    d = tmp_path_factory.mktemp("trace")
    fq = [str(d / "a.fq"), str(d / "b.fq")]
    synth.make_pe(*fq, 600, genome_size=6000, seed=3)
    return _compress(fq, str(d / "a.stpu"))


def _compress(fq, arc):
    api.clear_program_cache()       # a miss, and no program left behind
    try:
        cp = api.compress(fq, arc, api.CompressOptions(num_threads=2,
                                                       verbose=False),
                          device="cpu")
    finally:
        api.clear_program_cache()
    last = spans.context()[0]
    with ArchiveReader(arc) as r:
        members = list(r.names())
    return dict(spans=[s for s in spans.spans() if s.compress == last],
                stages=dict(short_mode.LAST_STAGE_SECONDS),
                stats=dict(engine.LAST_RUN_STATS), members=members,
                files=fq, archive=arc, params=cp)


@pytest.fixture(scope="module")
def pe_last_pair_breaks(tmp_path_factory):
    """pe_compress's kind of input, 300 pairs, the last file-2 id off the
    pattern of the first pair."""
    d = tmp_path_factory.mktemp("idbreak")
    fq = [str(d / "a.fq"), str(d / "b.fq")]
    synth.make_pe(*fq, 300, genome_size=3000, seed=4)
    with open(fq[1], "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[-5] == b"@SYN.300/2"
    lines[-5] = b"@SYN.300/3"
    with open(fq[1], "wb") as f:
        f.write(b"\n".join(lines))
    return _compress(fq, str(d / "a.stpu"))


def _key(s) -> str:
    return f"stitch[{s.attrs['n']}]" if s.name == "stitch" else s.name


def test_stage_spans_tile_the_compress_and_sum_to_stage_seconds(
        pe_compress):
    stages = sorted((s for s in pe_compress["spans"] if s.parent is None),
                    key=lambda s: s.start_ns)
    assert {s.thread for s in stages} == {threading.main_thread().name}
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns == b.start_ns               # in order, no overlap
    assert all(s.end_ns >= s.start_ns for s in stages)
    want = pe_compress["stages"]
    assert list(dict.fromkeys(_key(s) for s in stages)) == list(want)
    sums = collections.Counter()
    for s in stages:
        sums[_key(s)] += (s.end_ns - s.start_ns) / 1e9
        assert s.layer == short_mode.STAGE_LAYERS[s.name]
    for k, v in want.items():
        assert abs(sums[k] - v) <= 0.0005 + 1e-9, k
    idcheck = next(s for s in stages if s.name == "quantize+idcheck")
    assert idcheck.attrs == {"what": "pe_id_check", "pairs_checked": 600,
                             "code": 1}
    assert any(re.fullmatch(r"stitch\[\d+\]", k) for k in want)


@pytest.mark.parametrize("run,match", [("pe_compress", True),
                                       ("pe_last_pair_breaks", False)])
def test_pe_id_check_through_compress(run, match, request, tmp_path):
    """The native id check decides the archive's pattern flag as the
    per-pair check did, every pair checked; both archives read back
    byte for byte."""
    got = request.getfixturevalue(run)
    cp = got["params"]
    assert cp.paired_id_match is match
    assert cp.paired_id_code == (1 if match else 0)
    idcheck = next(s for s in got["spans"] if s.name == "quantize+idcheck")
    n = 600 if match else 300
    assert idcheck.attrs == {"what": "pe_id_check", "pairs_checked": n,
                             "code": 1}
    out = [str(tmp_path / "1.fq"), str(tmp_path / "2.fq")]
    api.decompress(got["archive"], out, num_threads=2, verbose=False)
    for a, b in zip(got["files"], out):
        assert filecmp.cmp(a, b, shallow=False)


def test_one_codec_span_a_member_under_the_stage_that_submitted_it(
        pe_compress):
    got = pe_compress["spans"]
    codecs = [s for s in got if s.name == "codec"]
    fams = collections.Counter(s.attrs["family"] for s in codecs)
    members = collections.Counter(m.rsplit(".", 1)[0]
                                  for m in pe_compress["members"]
                                  if m != "params.json")
    assert fams == members and len(codecs) == sum(members.values())
    stage = {s.id: s.name for s in got if s.parent is None}
    # order kept: ids and qualities go from the engine's first progress
    # callback, the rest once the contigs are laid out
    parents = {s.attrs["family"]: stage[s.parent] for s in codecs}
    assert parents["id"] == parents["quality"] == "reorder_run"
    assert parents["flag"] == "block_streams_submit"
    for s in codecs:
        a = s.attrs
        assert s.layer == "codecs" and s.thread != threading.main_thread().name
        assert a["submit_ns"] <= s.start_ns <= s.end_ns
        assert 0 <= a["write_ns"] <= s.end_ns - s.start_ns
        assert a["cpu_ns"] >= 0


def test_flush_spans_and_counters(pe_compress):
    st = pe_compress["stats"]
    assert st["flush_device_s"] is None             # no device on the CPU
    assert st["flush_wait_s"] > 0
    got = pe_compress["spans"]
    run_ = next(s for s in got if s.name == "reorder_run")
    flushes = [s for s in got if s.name == "flush"]
    assert len(flushes) == st["flushes"]
    assert all(s.parent == run_.id and s.layer == "reorder"
               and s.attrs["mode"] == "called"
               and s.attrs["device_ms"] is None
               and 0 <= s.attrs["wait_ms"] * 1e6 <= s.end_ns - s.start_ns
               and run_.start_ns <= s.start_ns <= s.end_ns <= run_.end_ns
               for s in flushes)
    wait_s = sum(s.attrs["wait_ms"] for s in flushes) / 1000
    assert abs(wait_s - st["flush_wait_s"]) <= 5e-5
    assert abs((max(s.end_ns for s in flushes)
                - min(s.start_ns for s in flushes)) / 1e9
               - st["flush_wall_s"]) <= 0.002


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def test_span_clock_is_the_profilers_on_the_cpu(fresh):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with record_function("stpu_test::clock"):
            torch.ones(64).sum()
        spans.record("clock", "io", t0, time.time_ns())
    ev = next(e for e in _events(prof) if e.name() == "stpu_test::clock")
    span = spans.spans()[-1]
    assert abs(ev.start_ns() - span.start_ns) < 5_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUPTI stamps the device's kernels "
                    "only there")
    return torch.device("cuda")


def test_cuda_kernel_lies_inside_the_span_around_it(cuda_device, fresh):
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4096, 4096, device=cuda_device)
    (x @ x).sum().item()                            # cuBLAS loaded
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(cuda_device)
        t0 = time.time_ns()
        y = x @ x
        torch.cuda.synchronize(cuda_device)
        spans.record("matmul", "kernel", t0, time.time_ns())
    del y
    span = spans.spans()[-1]
    kern = [e for e in _events(prof)
            if str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation()]
    assert kern
    for e in kern:
        assert span.start_ns <= e.start_ns(), (e.name(), e.start_ns())
        assert e.start_ns() + e.duration_ns() <= span.end_ns, e.name()
