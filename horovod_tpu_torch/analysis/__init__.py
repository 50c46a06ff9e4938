"""Invariant lint suite of the port (counterpart of
``horovod_tpu/analysis/``, docs/analysis.md).

The same three invariant families as the JAX package, pointed at the
port's own tree and programs:

* :mod:`~horovod_tpu_torch.analysis.schedule_lint` — structural checks
  over a recorded schedule: the operations one rank runs (aten ops with
  their result shapes, ``c10d`` collectives and the data plane's hop
  transfers with their member ranks, hand-kernel launches).  It takes
  the place of the reference's ``hlo_lint`` (the port has no HLO; the
  rule ids are ``SCHED-*`` with the reference's ``HLO-*`` suffixes);
* :mod:`~horovod_tpu_torch.analysis.knob_lint` — AST cross-referencing
  of the port's knob registry against raw env reads, the round-0
  handshake vector, what the data plane memoizes across responses, the
  launcher CLI, the port's bench scripts and the docs;
* :mod:`~horovod_tpu_torch.analysis.concurrency_lint` — a lock
  acquisition graph over the port's ``runtime/``, ``run/`` and
  ``common/``.

CLI: ``python -m horovod_tpu_torch.analysis [schedule|hlo|knobs|
concurrency|all] [--json]`` (``hlo`` is an alias of ``schedule``) —
exits non-zero on any finding not covered by a justified entry in
``horovod_tpu_torch/analysis/allowlist.json``.

The ``knobs`` and ``concurrency`` passes are pure AST work: no module
under lint is imported, only the stdlib-only config registry.  The
``schedule`` pass runs the program set (:mod:`.programs`) over eight
emulated ranks, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os

from horovod_tpu_torch.analysis.findings import Finding, SEVERITIES

__all__ = ["Finding", "SEVERITIES", "PASSES", "repo_root", "run_pass"]

#: The package under lint, as a path relative to :func:`repo_root`.
PACKAGE = "horovod_tpu_torch"


def repo_root() -> str:
    """The checkout root (parent of the ``horovod_tpu_torch`` package)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _run_knobs(package_dir: str | None = None, device=None) -> list:
    from horovod_tpu_torch.analysis import knob_lint

    return knob_lint.run(package_dir=package_dir)


def _run_concurrency(package_dir: str | None = None, device=None) -> list:
    from horovod_tpu_torch.analysis import concurrency_lint

    return concurrency_lint.run(package_dir=package_dir)


def _run_schedule(package_dir: str | None = None, device=None) -> list:
    # package_dir is accepted for CLI uniformity but unused: the
    # schedule pass lints recorded programs, not source trees.
    del package_dir
    from horovod_tpu_torch.analysis import programs

    return programs.run(device=device)


# Pass registry: name -> (runner, description).  Adding a pass =
# one entry here plus a module exposing run() -> list[Finding]
# (docs/analysis.md "adding a pass").
PASSES = {
    "knobs": (_run_knobs,
              "knob drift: raw env reads, handshake/memo-key/CLI/doc "
              "cross-references"),
    "concurrency": (_run_concurrency,
                    "lock-order cycles, signal-unsafe locks, blocking "
                    "calls under hot-path locks"),
    "schedule": (_run_schedule,
                 "residency/placement/schedule invariants of the "
                 "recorded program set"),
}

#: Names the CLI accepts for a pass besides its own: the reference's
#: scripts call the structural pass ``hlo``.
ALIASES = {"hlo": "schedule"}


def run_pass(name: str, package_dir: str | None = None,
             device=None) -> list:
    runner, _ = PASSES[ALIASES.get(name, name)]
    return runner(package_dir=package_dir, device=device)
