"""100 x the program's counter ``rt.rays_live`` over ``rt.rays_launched``:
the share of the bounces' closest-hit launch lanes that hold a live ray,
over every frame of the process.  The width ladder
(``RTConfig.bounce_width_ladder``) launches the rest for nothing.  None
where no bounce was launched (metrics/host_busy_ms.py)."""
from benchmark.metrics import host_busy_ms


def read(ctx):
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    c = tracing.counter_report()
    launched = c.get("rt.rays_launched", 0)
    return 100.0 * c.get("rt.rays_live", 0) / launched if launched else None
