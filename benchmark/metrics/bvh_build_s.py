"""Host seconds in the stage ``rt.prepare.bvh``, the SAH build of
``rt/tracer.RTScene.finalize``, during set-up: the program's stage
aggregates, which count with tracing off.  None where the stage never ran
(metrics/host_busy_ms.py)."""
from benchmark.metrics import host_busy_ms


def read(ctx):
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    bvh = tracing.stage_report().get("rt.prepare.bvh")
    return bvh["ms"] / 1e3 if bvh is not None else None
