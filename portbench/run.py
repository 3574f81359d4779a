"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration
(``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``); the configuration's ``family`` names the
module that meets the program (``portbench/families/<family>.py``) and its
plain reference (``portbench/reference/<family>.py``).  With ``--trace 1``
each per-layer metric of the cell is read by ``portbench/metrics/<name>.py``.

A run: set-up (weights and signals made on the card from ``--seed``, the
program's model built and loaded, only this cell's shapes warmed up, and for
a train mix the three steps that the comparison follows), then ``--seconds``
of measured traffic, then the memory peak, then the comparison with the
reference after the program's state is freed.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key, ``checks``.

Without a CUDA card (or with fewer cards than the cell asks for) it exits 2
and prints no result; it exits 3 if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, trace, weights  # noqa: E402
from portbench.reference.precision import STATED, float32_exact  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "eyegaze_tpu")
SEED_MOD = 2 ** 62


def process_start() -> float:
    """Seconds since the epoch at which this process started (the kernel's
    record of it), or the import of this module where that is not readable."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        since_boot = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / ticks
        return time.time() - since_boot
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``workload`` with its configuration, mix, family module and the
    per-layer metrics that list it (or list no cells)."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    metrics = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "mix": mix, "per_layer": metrics,
            "end_to_end": end_to_end,
            "family": importlib.import_module(f"portbench.families.{config['family']}")}


def metric_reader(name: str):
    """``portbench/metrics/<name>.py`` as a module (the name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- serving -------------------------------------------------------------------

class Schedule:
    """The requests of one window.  Closed loop: each client sends its next
    request when its last one returns, until the window's end.  Open loop
    (``rate_per_s``): requests are due on a seeded Poisson schedule made in
    set-up, sent by ``clients`` sender threads, and a request's latency runs
    from when it was due."""

    def __init__(self, mix: dict, rng: random.Random):
        self.open = mix.get("loop", "closed") == "open"
        self.lock = threading.Lock()
        self.offsets, self.next = [], 0
        if self.open:
            t, horizon = 0.0, float(mix["schedule_seconds"])
            while t < horizon:
                t += rng.expovariate(mix["rate_per_s"])
                self.offsets.append(t)

    def take(self, t_start: float, t_end: float):
        """The due time of the next request, or None when the window is over."""
        if not self.open:
            now = time.perf_counter()
            return now if now < t_end else None
        with self.lock:
            i = self.next
            self.next += 1
        if i >= len(self.offsets) or t_start + self.offsets[i] >= t_end:
            return None
        due = t_start + self.offsets[i]
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        return due


class Client(threading.Thread):
    """One sender: requests round-robin from its pool, each answer timed,
    and a seeded reservoir of ``keep`` answers for the comparison."""

    def __init__(self, index: int, pool: list, batcher, schedule: Schedule, start: threading.Event,
                 window: dict, answer, keep: int, seed: int):
        super().__init__(daemon=True, name=f"portbench-client-{index}")
        self.index, self.pool, self.batcher, self.schedule = index, pool, batcher, schedule
        self.start_event, self.window, self.answer = start, window, answer
        self.keep, self.rng = keep, random.Random(seed)
        self.records, self.kept, self.failed = [], [], 0

    def run(self) -> None:
        self.start_event.wait()
        t_start, t_end = self.window["start"], self.window["end"]
        n = 0
        while (due := self.schedule.take(t_start, t_end)) is not None:
            slot = n % len(self.pool)
            try:
                out = self.batcher.predict(*self.pool[slot])
            except Exception as e:  # noqa: BLE001 — a failed request is counted and reported
                self.failed += 1
                print(f"[portbench] request failed: {e!r}", file=sys.stderr)
                n += 1
                continue
            done = time.perf_counter()
            self.records.append((due, done, len(self.pool[slot][0])))
            item = (slot, self.answer(out))
            if len(self.kept) < self.keep:  # reservoir sampling of the answers
                self.kept.append(item)
            elif (j := self.rng.randrange(len(self.records))) < self.keep:
                self.kept[j] = item
            n += 1


def run_serve(setup: dict, args, device, tracer, stage) -> dict:
    cfg, mix, fam = setup["config"], setup["mix"], setup["family"]
    from eyegaze_tpu_torch.serving import DynamicBatcher

    params = weights.make_params(fam.shapes(cfg), args.seed % SEED_MOD, device)
    model = fam.program_model(cfg, {}, device)
    model.load_state_dict(params, strict=True)
    del params
    predictor = fam.predictor(model, mix, device)
    stage("model")
    pools = serve_pools(fam, cfg, mix, args.seed, device)
    stage("requests")
    rows = mix["request_windows"]
    for _ in range(mix.get("warmup_requests", 2)):  # this cell's bucket only
        predictor.predict(*pools[0][0])
    sync(device)
    batcher = DynamicBatcher(predictor, max_wait_ms=mix["max_wait_ms"])
    batcher.predict(*pools[0][0])
    stage("warm-up")
    for key in ("queue_wait_ms", "exec_ms", "dispatch_rows"):
        batcher.stats[key].clear()
    rng = random.Random(args.seed)
    schedule = Schedule(mix, rng)
    start, window = threading.Event(), {}
    clients = [Client(i, pool, batcher, schedule, start, window, fam.answer,
                      mix["check_requests"], rng.randrange(2 ** 32))
               for i, pool in enumerate(pools)]
    for c in clients:
        c.start()
    with tracer, torch.profiler.record_function(trace.WINDOW):
        window["start"] = t_start = time.perf_counter()
        window["end"] = t_start + args.seconds
        start.set()
        for c in clients:
            c.join()
        sync(device)
        t_close = max([t_start] + [r[1] for c in clients for r in c.records])
    batcher.close()
    records = [r for c in clients for r in c.records]
    lat_ms = sorted((done - due) * 1e3 for due, done, _ in records)
    windows = sum(n for _, _, n in records)
    elapsed = t_close - t_start
    kept = [(c.index, slot, out) for c in clients for slot, out in c.kept]
    return {
        "kind": "serve", "t_start": t_start, "elapsed": elapsed, "windows": windows,
        "attempted": len(records) + sum(c.failed for c in clients),
        "failed": sum(c.failed for c in clients),
        "end_to_end": {"serve_windows_per_s": windows / elapsed,
                       "serve_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else None},
        "latencies_ms": lat_ms,
        "batcher": {k: list(batcher.stats[k]) for k in ("queue_wait_ms", "exec_ms",
                                                        "dispatch_rows")},
        "rows": rows,
        "free": [batcher, predictor, model],
        "check": lambda: check_serve(setup, args, device, pools, kept),
    }


def serve_pools(fam, cfg: dict, mix: dict, seed: int, device) -> list:
    """Each client's pool of requests, float32 numpy arrays made on the card."""
    gen = torch.Generator(device=device).manual_seed((2 * seed + 1) % SEED_MOD)
    return [[tuple(a.cpu().numpy() for a in fam.requests(gen, cfg, mix["request_windows"]))
             for _ in range(mix["pool_per_client"])] for _ in range(mix["clients"])]


def reference_answers(fam, cfg: dict, params: dict, arrays, device, precision: str):
    """The reference's answers to one request, 32 rows at a time."""
    arrays = [torch.as_tensor(a, device=device) for a in arrays]
    with torch.no_grad(), float32_exact():
        return torch.cat([fam.reference_serve(params, cfg, [a[i:i + 32] for a in arrays],
                                              precision)
                          for i in range(0, len(arrays[0]), 32)]).float()


def check_serve(setup: dict, args, device, pools, kept) -> dict:
    """The sampled answers against the reference on the same requests."""
    if not kept:
        return {}  # every limited number then reads as missing, and fails
    cfg, fam = setup["config"], setup["family"]
    params = weights.make_params(fam.shapes(cfg), args.seed % SEED_MOD, device)
    got = [torch.as_tensor(out, device=device).float() for _, _, out in kept]
    arrays = [pools[client][slot] for client, slot, _ in kept]
    return compare.answer_gaps(got, *reference_pair(fam, cfg, params, arrays, device))


def reference_pair(fam, cfg: dict, params: dict, requests: list, device) -> tuple:
    """The reference's answers to ``requests`` in float32, and with its
    operands rounded to the configuration's stated precision (None where it
    states float32)."""
    want = [reference_answers(fam, cfg, params, a, device, "exact") for a in requests]
    stated = STATED.get(cfg["dtype"])
    rounded = stated and [reference_answers(fam, cfg, params, a, device, stated)
                          for a in requests]
    return want, rounded


# -- training ------------------------------------------------------------------

def program_steps(setup: dict, seed: int, device, stage=None) -> tuple:
    """The program's train step object (``Trainer`` over the model and its
    clip + AdamW) driven through the steps the reference follows, and their
    readings: each step's loss, the first gradient as AdamW got it, and the
    parameters after the last step."""
    cfg, mix, fam = setup["config"], setup["mix"], setup["family"]
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    stage = stage or (lambda name: None)
    params = weights.make_params(fam.shapes(cfg), seed % SEED_MOD, device)
    model = fam.program_model(cfg, mix, device)
    model.load_state_dict(params, strict=True)
    del params
    optimizer = make_optimizer(model, mix["lr"], mix["weight_decay"], grad_clip=mix["grad_clip"])
    trainer = Trainer(model, optimizer, fam.objective(cfg, mix), None,
                      TrainerConfig(seed=seed % 2 ** 31, prefetch=0), device=device)
    stage("model")
    batches = pool_batches(fam, cfg, mix, seed, device, mix["pool_batches"])
    stage("batches")
    names = [n for n, _ in model.named_parameters()]
    steps = [trainer.train_step(batches[0])]
    # AdamW's first moment after one update is (1 - beta1) g.
    states = [optimizer.adamw.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
              for p in model.parameters()]
    first_grad = torch.stack(torch._foreach_norm(states)) / (1 - 0.9)
    steps += [trainer.train_step(b) for b in batches[1:compare.TRAIN_STEPS]]
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    sync(device)
    stage("checked steps")
    readings = {"loss": [float(m["loss"]) for m in steps],
                "terms": {k: float(v) for k, v in steps[0].items() if k.startswith("loss_")},
                "grad": dict(zip(names, first_grad.tolist())), "after": after}
    return trainer, batches, readings


def run_train(setup: dict, args, device, tracer, stage) -> dict:
    mix = setup["mix"]
    trainer, batches, program = program_steps(setup, args.seed, device, stage)
    rows = mix["batch"]
    steps = 0
    with tracer, torch.profiler.record_function(trace.WINDOW):
        t_start = time.perf_counter()
        t_end = t_start + args.seconds
        while time.perf_counter() < t_end:
            trainer.train_step(batches[(compare.TRAIN_STEPS + steps) % len(batches)])
            steps += 1
        sync(device)
        elapsed = time.perf_counter() - t_start
    return {
        "kind": "train", "t_start": t_start, "elapsed": elapsed, "windows": steps * rows,
        "attempted": steps, "failed": 0,
        "end_to_end": {"train_windows_per_s": steps * rows / elapsed},
        "rows": rows,
        "free": [trainer, batches],
        "check": lambda: check_train(setup, args, device, program),
    }


def pool_batches(fam, cfg: dict, mix: dict, seed: int, device, count: int) -> list:
    """The first ``count`` batches of the seeded pool, on the device."""
    gen = torch.Generator(device=device).manual_seed((2 * seed + 1) % SEED_MOD)
    return [fam.train_batch(gen, cfg, mix["batch"]) for _ in range(count)]


def reference_steps(setup: dict, seed: int, device, precision: str = "exact",
                    rows: int | None = None) -> dict:
    """The reference through the first steps: each step's loss, the first
    clipped gradient's leaf norms, and the parameters after the last step;
    ``rows`` keeps the first rows of each batch alone (a planted fault)."""
    cfg, mix, fam = setup["config"], setup["mix"], setup["family"]
    from portbench.reference.optim import AdamW

    params = weights.make_params(fam.shapes(cfg), seed % SEED_MOD, device)
    start = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    opt = AdamW(params, mix["lr"], mix["weight_decay"], mix["grad_clip"])
    batches = pool_batches(fam, cfg, mix, seed, device, compare.TRAIN_STEPS)
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
    out = {"loss": [], "start": start}
    with float32_exact():
        for batch in batches:
            loss, terms, grads = compare.loss_and_grads(fam, params, cfg, batch, mix, precision)
            clipped = opt.step(grads)
            out["loss"].append(loss)
            if "grad" not in out:
                out["terms"] = terms
                out["grad"] = {k: float(g.norm()) for k, g in clipped.items()}
    out["after"] = {k: v.detach() for k, v in params.items()}
    return out


def check_train(setup: dict, args, device, program: dict) -> dict:
    ref = reference_steps(setup, args.seed, device)
    return compare.train_gaps(program, ref)


# -- the run -------------------------------------------------------------------

def power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(setup: dict, args, device) -> tuple[dict, dict]:
    """(result line, checks) of one run of the cell on ``device``."""
    t_process = process_start()
    torch.set_num_threads(2)
    tracer = trace.Tracer(bool(args.trace))
    kind = setup["mix"]["kind"]
    last = [t_process]

    def stage(name: str) -> None:
        now = time.time()
        print(f"[setup] {name} {now - last[0]:.3f} s", file=sys.stderr, flush=True)
        last[0] = now

    stage("process start to the harness")
    out = (run_serve if kind == "serve" else run_train)(setup, args, device, tracer, stage)
    setup_s = out["t_start"] - time.perf_counter() + time.time() - t_process
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out["setup_s"] = setup_s
    out["trace"] = tracer.summary
    out["config"], out["family"] = setup["config"], setup["family"]
    metrics = {}
    if args.trace:
        for m in setup["per_layer"]:
            value = metric_reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["end_to_end"], setup_s=setup_s)
        for m in setup["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    check = out.pop("check")
    out.pop("free").clear()  # the program's last references: its state goes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = check()
    checks = compare.judge(gaps, setup["config"]["limits"][kind])
    result = {
        "correct": all(c["ok"] for c in checks.values()) and out["failed"] == 0,
        "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit() if device.type == "cuda" else None},
    }
    if out["trace"] is not None:
        result["device"].update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k in gaps.keys() - checks.keys():
        print(f"[reading] {k} {gaps[k]!r} (not compared)", file=sys.stderr)
    return result, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup = resolve(args.workload)
    chips = setup["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result, checks = run_cell(setup, args, torch.device("cuda", 0))
    if loaded := forbidden_modules():
        print(f"[portbench] the run loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
