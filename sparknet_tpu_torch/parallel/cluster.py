"""The launcher's env contract, the one-process half.

The port's own copy of the env parsing of ``sparknet_tpu/parallel/
cluster.py`` (:56-102) and of ``local_batch_slice`` (:112).  The launcher
(``tools/launch.py``) sets SPARKNET_COORDINATOR / SPARKNET_NUM_PROCS /
SPARKNET_PROC_ID on every process it spawns, for a gang of one process
too.  The port runs a gang as one process whose workers share the card,
so it accepts a world of one process; a world of more is the process
group of the pod half and raises (ROADMAP A12, pod half).
"""

from __future__ import annotations

from ..utils import knobs

POD_HALF = "ROADMAP A12, pod half"


def init_cluster_from_env() -> bool:
    """Validate the env contract: False when it is absent (a process run
    by hand), True for a launched world of one process.  A partial or
    malformed contract raises ValueError naming the variable; a world of
    more than one process raises NotImplementedError."""
    addr = knobs.raw("SPARKNET_COORDINATOR")
    if not addr:
        for var in ("SPARKNET_NUM_PROCS", "SPARKNET_PROC_ID"):
            if knobs.raw(var):
                raise ValueError(
                    f"{var} is set but SPARKNET_COORDINATOR is not — the "
                    f"launcher env contract requires all three of "
                    f"SPARKNET_COORDINATOR / SPARKNET_NUM_PROCS / "
                    f"SPARKNET_PROC_ID")
        return False
    values = {}
    for var in ("SPARKNET_NUM_PROCS", "SPARKNET_PROC_ID"):
        raw = knobs.raw(var)
        if raw is None or raw == "":
            raise ValueError(
                f"SPARKNET_COORDINATOR is set but {var} is missing — the "
                f"launcher must export SPARKNET_COORDINATOR, "
                f"SPARKNET_NUM_PROCS, and SPARKNET_PROC_ID together")
        try:
            values[var] = int(raw)
        except ValueError:
            raise ValueError(
                f"{var}={raw!r} is not an integer") from None
    nprocs, pid = values["SPARKNET_NUM_PROCS"], values["SPARKNET_PROC_ID"]
    if nprocs < 1:
        raise ValueError(f"SPARKNET_NUM_PROCS={nprocs} must be >= 1")
    if not 0 <= pid < nprocs:
        raise ValueError(
            f"SPARKNET_PROC_ID={pid} out of range for "
            f"SPARKNET_NUM_PROCS={nprocs} (want 0 <= id < num_procs)")
    if nprocs > 1:
        raise NotImplementedError(
            f"SPARKNET_NUM_PROCS={nprocs}: a gang of several processes "
            f"needs a process group, which is not ported yet ({POD_HALF}); "
            f"run one process with --local-devices N workers")
    return True


def local_batch_slice(global_batch: int) -> slice:
    """The half-open row range of the global batch this process feeds
    (the reference's partition placement, ImageNetApp.scala:145): the
    whole batch, since a gang is one process."""
    return slice(0, global_batch)
