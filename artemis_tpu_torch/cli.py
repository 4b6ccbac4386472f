"""Command-line entry point (reference: src/main.cpp; port of
``artemis_tpu/cli.py``).

Usage:  python -m artemis_tpu_torch.cli -i input.deck [-d data_dir]
            [-r checkpoint.rst.npz] [-t seconds] [--device cuda|cpu]
            [--profile N] [--profile-kernels N] [key=value ...]
Return codes: 0 complete, 1 failed, 2 walltime timeout (after writing
``{problem_id}.walltime.final.rst.npz`` in the data directory, which
``-r`` resumes).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="artemis_tpu_torch")
    ap.add_argument("-i", "--input", required=True, help="input deck file")
    ap.add_argument("-d", "--data", default=".", help="output data directory")
    ap.add_argument("-r", "--restart", default=None, help="restart checkpoint (.rst.npz)")
    ap.add_argument("-n", "--ncycle-out", type=int, default=0, help="stdout log interval")
    ap.add_argument("-t", "--walltime", type=float, default=None,
                    help="wall-clock limit in seconds (exit code 2 on timeout)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="time N instrumented cycles per driver phase and "
                         "print the table before the run (Kokkos-Tools "
                         "named-kernel profiling analogue)")
    ap.add_argument("--profile-kernels", type=int, default=0, metavar="N",
                    help="time every kernel launch over N cycles and print "
                         "the per-kernel table before the run (below-phase "
                         "attribution; see profiling.kernel_table)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the "
                         "plain tensor path on the host)")
    ap.add_argument("overrides", nargs="*", help="block/key=value overrides")
    args = ap.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available "
                           "(pass --device cpu to run on the host)")

    import signal

    from . import driver as _driver
    from .simulation import Simulation

    def _on_term(signum, frame):  # noqa: ARG001
        _driver.STOP_REQUESTED = True

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread
        pass

    try:
        sim = Simulation(args.input, overrides=args.overrides, data_dir=args.data,
                         device=args.device, restart=args.restart)
        sim.print_config()
        if args.profile > 0:
            from .profiling import phase_table

            phase_table(sim, ncycles=args.profile)
        if args.profile_kernels > 0:
            from .profiling import kernel_table

            kernel_table(sim, ncycles=args.profile_kernels)
        from . import profiling

        n0, reads0, wait0 = sim.tm.ncycle, profiling.host_reads, profiling.host_read_wait_s
        zcps = sim.run(log_every=args.ncycle_out, walltime=args.walltime)
        ncyc = max(sim.tm.ncycle - n0, 1)
        print(f"walltime-rate: {zcps:.3e} zone-cycles/sec "
              f"(ncycle={sim.tm.ncycle}, t={sim.tm.time:.6e}, {sim.status}); host reads "
              f"{(profiling.host_reads - reads0) / ncyc:.2f} a cycle, waiting "
              f"{1e3 * (profiling.host_read_wait_s - wait0) / ncyc:.3f} ms a cycle")
        if sim.status == "timeout":
            # write a resume checkpoint and signal the self-resubmit pattern
            # (DriverStatus::timeout -> exit code 2, src/main.cpp:108-138)
            import os

            pid = sim.pin.get_or_add_str("parthenon/job", "problem_id", "artemis")
            path = sim.write_restart(os.path.join(sim.data_dir, f"{pid}.walltime"))
            print(f"walltime checkpoint: {path}")
            return 2
    except Exception as e:  # noqa: BLE001
        print(f"artemis_tpu_torch failed: {e}", file=sys.stderr)
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
