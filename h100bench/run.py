"""The benchmark of ``artemis_tpu_torch`` on one NVIDIA H100: one cell, one
run.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the cell's ``Simulation`` on
``cuda:0`` from the deck in ``configs/`` with the traffic's overrides,
perturbs the initial density and velocities from the seed, warms up
through the program's evolution loop (``driver.evolve``), and drives the
same loop on for ``--seconds``.  After the window it holds what the
warm-up's cycles produced against the plain reference under
``reference/`` (``check.py``) and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted`` and ``failed`` (cycles),
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, which adds a profiled window, the program's phase table
and a device breakdown), ``device``, and last ``checks``: each number
compared beside its limit.  Earlier lines on standard error give the card
(``nvidia-smi``), the set-up split and the checks.  A run that finds no
card, or fewer cards than the cell asks for, exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that
# prints the result (the JAX package's name is a prefix of the port's, so
# names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "artemis_tpu")
# the kernel caches the program or PyTorch may write, at fixed paths
# inside the checkout (the program's nvcc builds go to
# artemis_tpu_torch/_build/ by themselves)
CACHE = ROOT / ".h100bench_cache"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def smi_line(query="name,power.limit,clocks.sm,clocks.max.sm") -> str:
    """What nvidia-smi reads of the card: by default its name, power limit
    and SM clocks."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _number(v):
    return v if math.isfinite(v) else str(v)


def end_to_end(run) -> dict:
    """Every end-to-end quantity a run measures.  A metric of
    BENCHMARK.json reports the quantity its name begins with (the part
    before the first dot, ``spec.quantity``): ``zone_cycles_per_s.rhd`` is
    the rate of ``zone_cycles_per_s`` under a bound of its own."""
    w = run.window
    cyc = w["cycle_ms"]
    return {"zone_cycles_per_s": run.cells * w["cycles"] / w["seconds"],
            "cycle_ms_p95": statistics.quantiles(cyc, n=20)[18] if len(cyc) >= 2 else math.nan,
            "peak_mem_gib": w["peak_bytes"] / 2 ** 30, "setup_s": run.setup_s}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda:0",
             t_start=T_START, precision=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields.
    ``precision`` overrides the program's (the lower-precision control:
    the reference keeps the configuration's)."""
    import torch

    from h100bench import check, program, spec
    from h100bench import trace as trace_mod
    from h100bench.states import apply_perturbation, compare, copy_states, node_shapes, \
        node_states, perturbation

    p = cell.params
    on_card = torch.device(device).type == "cuda"
    amp = cell.traffic["perturb_amp"]
    split = {}
    t = time.perf_counter()
    import artemis_tpu_torch  # noqa: F401
    from artemis_tpu_torch import _build
    from artemis_tpu_torch.radiation import initialize_radiation
    split["import the program"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as data:
        t = time.perf_counter()
        sim = program.build(cell, device, data, precision)
        split["Simulation"] = time.perf_counter() - t
        if on_card and sim.driver.stage_kernel != p["stage_kernel"]:
            raise RuntimeError(f"{cell.name}: the stage path is {sim.driver.stage_kernel!r}, "
                               f"the cell measures {p['stage_kernel']!r}")
        t = time.perf_counter()
        apply_perturbation(sim, perturbation(node_shapes(sim), seed, amp, device, sim.dtype),
                           initialize_radiation)
        program.sync(device)
        split["perturbation"] = time.perf_counter() - t
        t = time.perf_counter()
        start_host = copy_states(node_states(sim), device="cpu")
        copy_s = time.perf_counter() - t
        run = program.Run(sim, device)
        t = time.perf_counter()
        k = p["warmup_cycles"]
        run.advance(ncycles=k)
        program.sync(device)
        split[f"warm-up ({k} cycles)"] = time.perf_counter() - t
        # what the warm-up's cycles produced, for the check: the same
        # object and loop then run the window
        t = time.perf_counter()
        warm_host = copy_states(node_states(sim), device="cpu")
        program_dts = list(run.dts)
        copy_s += time.perf_counter() - t
        setup_s = time.perf_counter() - t_start - copy_s
        log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
            + f"; setup_s {setup_s:.3f} s (the copies to the host for the check, before and "
            f"after the warm-up, {copy_s:.3f} s, left out)")
        # a checkout's first run builds the kernels inside set-up (with
        # ``nvcc``, into artemis_tpu_torch/_build/); later runs load them
        log(f"kernel builds: {len(_build.build_log)} in "
            f"{sum(v[0] for v in _build.build_log.values()):.3f} s of the set-up"
            + "".join(f"; {k} {v[0]:.3f} s" for k, v in _build.build_log.items()))

        # the measured window
        clock = program.Clock(device)
        c0 = program.counters()
        program.sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cycles = run.advance(seconds=seconds, clock=clock)
        program.sync(device)
        window = {"cycles": cycles, "seconds": time.perf_counter() - t0,
                  "cycle_ms": clock.intervals_ms(),
                  "peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
                  "counters": {k: v - c0[k] for k, v in program.counters().items()}}
        rec = SimpleNamespace(cell=cell, window=window, setup_s=setup_s, cells=run.cells(),
                              dtype=sim.dtype, trace=None, host_trace=None, phases=None,
                              calls={}, flops=None,
                              phase_cycles=p["phase_cycles"])
        log(f"window: {cycles} cycles in {window['seconds']:.6f} s over {rec.cells} cells; "
            f"launches {window['counters']}")
        if on_card:
            log("card after the window: "
                + smi_line("clocks.sm,temperature.gpu,power.draw,power.limit"))
        if trace:
            n = p["trace_cycles"]
            rec.trace = trace_mod.traced(lambda: run.advance(ncycles=n), n, device, host=False)
            with program.spans(sim, rec.calls):
                rec.host_trace = trace_mod.traced(lambda: run.advance(ncycles=n), n, device)
            for name, t in (("device pass", rec.trace), ("host pass", rec.host_trace)):
                log(f"{name}: {t.summary()}")
                if cycles:
                    log(f"{name}: {t.window_s / n:.6f} s a traced cycle against "
                        f"{window['seconds'] / cycles:.6f} s untraced")
            rec.phases = program.phase_table(sim, p["phase_cycles"])

        # the program freed before the reference runs
        del run, sim
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers, ref_dts, ref_final, rec.flops = check.reference_run(
        cell, device, seed, start_host, k, count_flops=trace)
    numbers["dt_err"] = check.dt_gap(program_dts, ref_dts)
    numbers.update({f"{key}_err": v for key, v in compare(warm_host, ref_final).items()})
    log(f"reference: {time.perf_counter() - t:.3f} s (start check, the {k} warm-up cycles "
        f"from the start{', operations counted' if trace else ''})")
    limits = p["limits"]
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"{cell.name}: no limit for {sorted(missing)}")
    out = {"correct": check.decide(numbers, limits), "attempted": cycles, "failed": 0}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(rec)
            if value is None:
                # left out of the line, as a reader that finds nothing to
                # read leaves it; said here, since the cell lists it
                log(f"per-layer metric {m['name']} found nothing to read in {cell.name}")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(rec)
        metrics = {m["name"]: {"value": e2e[spec.quantity(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                     "count": 1, "memory_peak_bytes": window["peak_bytes"]}
    if trace:
        out["device"].update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["breakdown"] = {"device_ops": [list(kv) for kv in rec.trace.top_ops],
                            "idle_gaps": [list(kv) for kv in rec.host_trace.idle_gaps]}
    out["checks"] = {name: {"value": _number(v), "limit": limits[name]}
                     for name, v in numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench.spec import load_cell

    cell = load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    t = time.perf_counter()
    import torch

    import_torch = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        log(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"nvidia-smi: {smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}; import torch {import_torch:.3f} s")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {bad}: the benchmark measures artemis_tpu_torch alone")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
