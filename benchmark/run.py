"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  Set-up makes the cell's genome and read pool
from --seed, builds the index in memory through the port's own functions
(no .sa5, .lch or .devidx is written) and warms the cell's bucket.  The
window then feeds TorchMapper.map_stream_sam chunks from the pool, closed
loop, for --seconds; with --trace 1 a torch.profiler trace covers it.
Once the window has closed the program's state is freed and a sample of
the records it returned is judged against the plain reference
(benchmark/reference.py, benchmark/judge.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones, each read by benchmark/metrics/<name>.py), device, with
--trace 1 breakdown, and last `compared`, each number compared beside its
limit.  With no CUDA device, or fewer than the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import deque  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "longreadmapper_tpu")
COUNTERS = ("retried_reads", "retried_sat_chunks", "overflow_reads",
            "raw_chunks", "host_chunks")


def process_start() -> float:
    """perf_counter() at this process's start (from /proc, to 10 ms), or
    at this module's import where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_of(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration file, traffic mix and metrics,
    found by the names in BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(workload=w, config=load_json(ROOT, conf["file"]),
                traffic=load_json(BENCH, "traffic", w["traffic"] + ".json"),
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def reader(name: str):
    """benchmark/metrics/<name>.py's `read(run) -> value or None`."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ set-up

class Stages:
    """Seconds of each set-up stage, from the process's start."""

    def __init__(self, t0: float):
        self.at = t0
        self.seconds = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.at, 3)
        self.at = now


def build_mapper(config: dict, fasta: str, device, stage=lambda s: None):
    """The port's index of `fasta`, built in memory as
    runtime/accidx.py::build_index composes it (create_meta, the SA-IS of
    sa_build without its .sa5, FMIndex.build, bwt_arrays, lc_build_device),
    on `device`, and a TorchMapper over it."""
    import torch
    from longreadmapper_tpu_torch.formats.catmeta import create_meta, \
        load_cat
    from longreadmapper_tpu_torch.index.device import build_device_index, \
        bwt_arrays
    from longreadmapper_tpu_torch.index.fmi import FMIndex
    from longreadmapper_tpu_torch.index.lchash import lc_build_device
    from longreadmapper_tpu_torch.index.sa import suffix_array
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.utils.config import Params

    m = config["mapper"]
    p = Params(seed_len=int(m["seed_len"]), thres=int(m["thres"]),
               hlen=int(m["hlen"]))
    stage("imports")
    mta = create_meta(fasta, n_seed=p.n_seed)
    prefix = fasta + ".cat"
    cat = load_cat(prefix)
    stage("create_meta")
    sa = suffix_array(cat)
    stage("suffix array")
    fmi = FMIndex.build(prefix, o_ratio=p.o_ratio, csa_ratio=p.csa_ratio,
                        sa=sa)
    arrays, dollar_pos = bwt_arrays(fmi)
    stage("FM index")
    n = fmi.length
    c4 = fmi.c4().astype("int64" if n >= 2**31 else "int32")
    kl = lc_build_device(torch.from_numpy(arrays["packed"]).to(device),
                         torch.from_numpy(arrays["occ_samp"]).to(device),
                         torch.from_numpy(c4).to(device), dollar_pos, n,
                         p.hlen)
    del arrays
    stage("lchash")
    idx, meta = build_device_index(fmi, kl, p.hlen, cat, mta, device)
    del fmi, kl, sa, cat
    stage("device index")
    return TorchMapper(idx, meta, mta, p, chunk_b=int(m["chunk_b"]),
                       device=device)


def snapshot(mapper) -> dict:
    """The mapper's counters and phase seconds; a counter the program no
    longer has reads None, and the metrics that need it are left out."""
    s = {k: getattr(mapper, k, None) for k in COUNTERS}
    s.update({"phase." + k: v
              for k, v in getattr(mapper, "phase_s", {}).items()})
    return s


def change(a, b):
    return None if a is None or b is None else b - a


# ------------------------------------------------------------------ window

def window(mapper, pool, seconds: float, keep_share: float, seed: int,
           tracer=None) -> dict:
    """Feed map_stream_sam the pool's chunks (closed loop: the stream pulls
    the next when its queue has room) until `seconds` have passed since
    the first pull, then let it drain.  Returns the window's chunks, the
    counters' change over it and the texts kept for the comparison."""
    from benchmark.traffic import rng_for
    keep_rng = rng_for(seed, 3)
    pulled = deque()
    if tracer is not None:
        tracer.start()
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def feed():
        c = 0
        while time.perf_counter() < t_end:
            k = c % pool.n_chunks
            ids = pool.chunk(k)
            reads = [(f"c{c // pool.n_chunks}.r{i}", pool.seqs[i],
                      pool.quals[i]) for i in ids]
            pulled.append((c, k, time.perf_counter()))
            yield reads
            c += 1

    done, late, kept = [], [], {}
    s0 = s_last = snapshot(mapper)
    for text, n, _ in mapper.map_stream_sam(feed()):
        t = time.perf_counter()
        c, k, t_pull = pulled.popleft()
        if t > t_end:
            if tracer is not None:
                tracer.stop()
            late.append(dict(chunk=c, reads=pool.chunk_reads, returned=n))
            continue
        s = snapshot(mapper)
        lengths = pool.lengths[pool.chunk(k).start:pool.chunk(k).stop]
        done.append(dict(chunk=c, latency_s=t - t_pull, end_s=t - t_start,
                         reads=pool.chunk_reads, returned=n,
                         bases=int(lengths.sum()), lengths=lengths.tolist(),
                         retried=change(s_last["retried_reads"],
                                        s["retried_reads"])))
        s_last = s
        if keep_rng.random() < keep_share:
            kept[c] = (k, text)
    if tracer is not None:
        tracer.stop()
    delta = {k: change(s0[k], s_last.get(k)) for k in s0}
    return dict(chunks=done, late=late, counters=delta, kept=kept)


# ------------------------------------------------------------- the check

def sample(pool, kept: dict, check: dict, seed: int) -> list:
    """(chunk ordinal, read index in the pool) of the reads judged: the
    longest read and check["reads"] - 1 more drawn at random, all from
    the chunks kept, from the seed."""
    from benchmark.traffic import rng_for
    rng = rng_for(seed, 4)
    cand = [(c, i) for c in sorted(kept) for i in pool.chunk(kept[c][0])]
    if not cand:
        return []
    longest = max(cand, key=lambda x: pool.lengths[x[1]])
    rest = [x for x in cand if x != longest]
    n = max(0, min(int(check["reads"]) - 1, len(rest)))
    return sorted([longest] + [rest[j] for j in rng.choice(len(rest), n,
                                                            replace=False)])


def records_of(pool, kept: dict, picks: list) -> list:
    """The tab-split record the stream returned for each pick, or None."""
    lines = {}
    out = []
    for c, i in picks:
        if c not in lines:
            lines[c] = kept[c][1].split("\n")
        at = i - pool.chunk(kept[c][0]).start
        rows = lines[c]
        out.append(rows[at].split("\t") if at < len(rows) and rows[at]
                   else None)
    return out


def check(genome, config, pool, win: dict, check_spec: dict, seed: int,
          device) -> dict:
    """Judge the sampled records against the plain reference."""
    from benchmark.judge import judge
    from benchmark.reference import Reference
    picks = sample(pool, win["kept"], check_spec, seed)
    if not picks:
        return dict(records_wrong=0, sampled=0, sampled_full_band=0)
    recs = records_of(pool, win["kept"], picks)
    reads = [(f"c{c // pool.n_chunks}.r{i}", pool.seqs[i]) for c, i in picks]
    ref = Reference(genome, int(config["mapper"]["seed_len"]),
                    int(config["mapper"]["thres"]), device)
    exp = ref.map_reads([s for _, s in reads])
    counts = judge(recs, reads, exp, ref)
    # the first wrong records, each with the repeat families its read's
    # window overlaps, for the run's standard error
    counts["wrong"] = [
        [reads[j][0], bad, sorted({f for f, a, b in genome.copies
                                   if a < pool.origin[picks[j][1]]
                                   + pool.lengths[picks[j][1]]
                                   and b > pool.origin[picks[j][1]]})]
        for j, bad in counts["wrong"][:8]]
    counts["sampled"] = len(picks)
    counts["sampled_full_band"] = full_band(exp, [s for _, s in reads])
    return counts


def full_band(expected: list, seqs: list) -> int:
    """The reads among `expected` that map only through the full-band
    retry: their distance reaches their bucket's first-pass half band."""
    from benchmark.reference import first_pass_band
    return sum(e.valid and e.ed >= first_pass_band(len(s))
               for e, s in zip(expected, seqs))


# -------------------------------------------------------------------- run

def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """One run of `cell` (cell_of's dict) on `device`; `t0` is the
    process's start on perf_counter's clock.  Returns the result's parts:
    run (the record metric readers read), counts (the comparison), device
    facts and the breakdown."""
    import torch
    from benchmark import devtrace
    from benchmark.traffic import make_genome, make_pool, write_fasta

    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stage = Stages(t0)
    stage("python, torch, CUDA")
    genome = make_genome(config["genome"], seed)
    stage("genome")
    pool = make_pool(genome, traffic, seed, device)
    stage("read pool")
    with tempfile.TemporaryDirectory(prefix="lrm-bench-") as tmp:
        fasta = os.path.join(tmp, "genome.fa")
        write_fasta(fasta, genome)
        mapper = build_mapper(config, fasta, device, stage)
    peak_build = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mapper.warmup([max(pool.lengths[pool.chunk(k).start:
                                    pool.chunk(k).stop])
                   for k in range(pool.n_chunks)])
    # one pass of real chunks through the stream: the retry tiers' shapes
    # and the allocator's pools on real data, before the window
    for _ in mapper.map_stream_sam(
            [[("warm", pool.seqs[i], pool.quals[i]) for i in pool.chunk(k)]
             for k in range(min(2, pool.n_chunks))]):
        pass
    stage("warm-up")
    tracer = None
    if trace:
        devtrace.wrap_spans(mapper)
        tracer = devtrace.Tracer()
    if cuda:
        torch.cuda.synchronize(dev)
    t_win = time.perf_counter()
    print("set-up s: " + json.dumps(stage.seconds), file=sys.stderr)
    win = window(mapper, pool, seconds, float(traffic["check"]["keep_share"]),
                 seed, tracer)
    if cuda:
        torch.cuda.synchronize(dev)
    peak_after = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = dict(setup_s=t_win - t0, window_s=float(seconds),
               chunks=win["chunks"], counters=win["counters"],
               peak_bytes=peak_after,
               layers=load_json(BENCH, "kernel_layers.json"))
    facts = dict(memory_peak_bytes=max(peak_build, peak_after))
    out = dict(run=run, facts=facts)
    if tracer is not None:
        tr = tracer.record(seconds)
        run["trace"] = tr
        facts["busy_s"] = sum(
            b - a for a, b in devtrace.reduce.merged(
                [(a, b) for _, a, b in tr["device_ops"]], *tr["window"]))
        facts["window_s"] = float(seconds)
        out["breakdown"] = devtrace.breakdown(tr)
        del tracer
    del mapper
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts = check(genome, config, pool, win, traffic["check"], seed, device)
    print(f"check s: {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    counts["late_chunks"] = len(win["late"])
    counts["failed"] = sum(ch["reads"] - ch["returned"]
                           for ch in win["chunks"] + win["late"])
    out["counts"] = counts
    return out


def result_line(cell: dict, parts: dict, trace: bool, device_kind: str,
                count: int) -> dict:
    run, counts = parts["run"], parts["counts"]
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(platform="gpu", kind=device_kind, count=count,
                  memory_peak_bytes=int(parts["facts"]["memory_peak_bytes"]))
    if trace:
        device["busy_s"] = parts["facts"]["busy_s"]
        device["window_s"] = parts["facts"]["window_s"]
    # a read of the window that came back without its record is wrong too
    wrong = counts["records_wrong"] + counts["failed"]
    line = dict(correct=bool(wrong == 0 and counts["sampled"] > 0),
                attempted=sum(ch["reads"] for ch in run["chunks"]),
                failed=counts["failed"], metrics=metrics, device=device)
    if trace:
        line["breakdown"] = parts["breakdown"]
    line["compared"] = {"records_wrong": {"value": wrong, "limit": 0}}
    return line


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # the checkout's root, not this folder, is where packages come from
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    # one thread for torch's host-side operations: the stream's host work
    # is one Python thread, and idle intra-op threads that spin beside it
    # slowed a host-paced cell by ~10% and widened its spread (PERF.md)
    os.environ["OMP_NUM_THREADS"] = "1"
    cell = cell_of(load_json(ROOT, "BENCHMARK.json"), args.workload)
    chips = int(cell["workload"]["chips"])

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    parts = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t0)
    line = result_line(cell, parts, bool(args.trace),
                       torch.cuda.get_device_name(0), chips)
    bad = loaded_forbidden()
    if bad:
        print(f"modules the benchmark must not load: {bad}", file=sys.stderr)
        return 3
    counts = parts["counts"]
    print("the check: " + json.dumps(counts), file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
