"""Performance counters — the MPM / vx_dump_perf analog (SURVEY §2.2 H6).

Counterpart of skybox_rt_tpu.runtime.perf.  The reference multiplexes
per-unit hardware counters through the MPM CSR file (classes: pipeline,
memsys, tex, raster, om — VX_types.vh:33-40; aggregation
runtime/stub/utils.cpp:159-340).  The port reports two layers:

  * measured: wall/device time, launches, bytes to/from host, Mpix/s, rays/s
  * analytic per-draw traffic model (the S6/S7/S8 mem-trace analog):
    raster reads (tile headers + pid lists + edge data), tex reads
    (texel fetches), om reads/writes (zbuf/cbuf words) — computed from the
    binning output exactly as the reference's units would issue them

Rooflines are placed against ``H100_PEAKS``.  The JAX package's
``cost_analysis`` and ``roofline_of_fn`` read XLA's cost model, which torch
has not; the port's kernel bounds are the work counts that chip_smoke.py
computes from each run's inputs.
"""
from __future__ import annotations

import collections
import sys

from ..core import constants as C


class PerfCounters:
    def __init__(self):
        self.counters = collections.Counter()
        self.times_ms = collections.Counter()

    def count(self, name: str, value=1):
        self.counters[name] += value

    def add_time(self, name: str, ms: float):
        self.times_ms[name] += ms

    def merge(self, other: "PerfCounters"):
        self.counters.update(other.counters)
        self.times_ms.update(other.times_ms)

    def as_dict(self) -> dict:
        out = dict(self.counters)
        out.update({k: v for k, v in self.times_ms.items()})
        return out

    def dump(self, file=None):
        file = file or sys.stdout
        print("PERF: " + "-" * 50, file=file)
        for k in sorted(self.counters):
            print(f"PERF: {k:<36} {self.counters[k]:>14}", file=file)
        for k in sorted(self.times_ms):
            print(f"PERF: {k:<36} {self.times_ms[k]:>14.3f} ms", file=file)


# Data-sheet peaks of one NVIDIA H100 SXM at its full 700 W: the device
# memory rate (HBM3) and float32 outside the tensor cores (NVIDIA's data
# sheet), int32 outside the tensor cores (the H100 architecture whitepaper:
# half of an SM's 128 float32 lanes also do int32).  A card set below 700 W
# runs slower under load.
H100_PEAKS = {
    "f32_flops_per_s": 67e12,
    "i32_ops_per_s": 33.5e12,
    "hbm_bytes_per_s": 3.35e12,
}


def roofline(flops: float, bytes_accessed: float, seconds: float,
             peaks: dict = H100_PEAKS, flops_key: str = "f32_flops_per_s"
             ) -> dict:
    """Roofline placement of one measured kernel/program (the reference
    analog is the per-unit counter report, runtime/stub/utils.cpp:159-340).

    flops/bytes_accessed: program totals; seconds: measured time.  Returns
    achieved rates, the percent-of-peak on each axis, the arithmetic
    intensity vs the ridge point, and which roof bounds the program.
    pct_of_roofline is the achieved rate on the BINDING axis over that
    axis's peak.
    """
    f_rate = flops / seconds
    b_rate = bytes_accessed / seconds
    pk_f = peaks[flops_key]
    pk_b = peaks["hbm_bytes_per_s"]
    intensity = flops / max(bytes_accessed, 1.0)
    ridge = pk_f / pk_b
    compute_bound = intensity >= ridge
    pct = (f_rate / pk_f if compute_bound else b_rate / pk_b) * 100.0
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "seconds": seconds,
        "achieved_tflops_per_s": f_rate / 1e12,
        "achieved_gb_per_s": b_rate / 1e9,
        "pct_of_flop_peak": f_rate / pk_f * 100.0,
        "pct_of_hbm_peak": b_rate / pk_b * 100.0,
        "arith_intensity_flops_per_byte": intensity,
        "ridge_flops_per_byte": ridge,
        "bound_by": "flops" if compute_bound else "hbm",
        "pct_of_roofline": pct,
    }


def traffic_bytes(traffic: dict) -> int:
    """Total modeled device-memory bytes in a drawcall_traffic /
    FrameStats.traffic dict (every *_bytes field, measured or upper-bound)."""
    return int(sum(v for k, v in traffic.items() if k.endswith("_bytes")
                   or "_bytes" in k))


def roofline_from_traffic(traffic: dict, seconds: float,
                          peaks: dict = H100_PEAKS) -> dict:
    """Roofline placement from the MEASURED unit-traffic model (tex/om/
    raster bytes the reference's units would issue, ops.deferred measured
    fragment counts): achieved useful bytes/s vs the memory peak.  FLOPs
    are not modeled (the raster path's integer work is not the binding
    axis)."""
    out = roofline(0.0, traffic_bytes(traffic), seconds, peaks=peaks)
    out["bound_by"] = "hbm"
    out["pct_of_roofline"] = out["pct_of_hbm_peak"]
    out["bytes_model"] = "measured_unit_traffic"
    return out


def format_roofline_table(rows: dict) -> str:
    """rows: {name: roofline dict} -> aligned text table."""
    lines = [f"{'path':<28} {'ms':>8} {'TF/s':>7} {'GB/s':>7} "
             f"{'%FLOP':>6} {'%HBM':>6} {'bound':>6} {'%roof':>6}"]
    for name, r in rows.items():
        lines.append(
            f"{name:<28} {r['seconds']*1e3:>8.3f} "
            f"{r['achieved_tflops_per_s']:>7.2f} "
            f"{r['achieved_gb_per_s']:>7.1f} "
            f"{r['pct_of_flop_peak']:>6.1f} {r['pct_of_hbm_peak']:>6.1f} "
            f"{r['bound_by']:>6} {r['pct_of_roofline']:>6.1f}")
    return "\n".join(lines)


def diff_step_traffic(params, static, cfg, slots: int,
                      fwd_bwd: bool = True, optimizer: str = "sgd") -> dict:
    """Unit-traffic model of one K-slot diff-pipeline train step.

    Every stream of the deferred diff pipeline is dense with a static shape
    (visibility scans all (tile, prim-slot) pairs, shade touches every
    (pixel, slot)), so the stream sizes below are exact by construction.
    Streams mirror diff/pipeline.py's data flow:

      prim_setup    3 corner-row gathers of pos/color/uv + setup writes;
                    backward = the transpose accumulation (P rows -> V)
      visibility    per-(tile, prim-slot) record reads (edges 36 B +
                    z 12 B) + slot-step writes; integer, no backward stream
      record_gather two-level gather: (P,C) rows -> (T,M,C) table, then
                    1 row/pixel/slot; backward = the table's gradient +
                    the row accumulation
      texture       one 4C-quad-row read per textured pixel-slot (64 B);
                    backward = the quad table's accumulation + quad->tex fold
      composite     fb carry read+write per slot + final image write
      loss          pred+target reads
      optimizer     param+grad reads, param writes (sgd: 3x params)

    ``params`` and ``static`` are dicts of arrays or tensors (only shapes
    are read).  Returns a dict of per-stream byte fields (suffix
    ``_bytes``) + ``bytes_total``; feed to roofline_from_traffic.
    """
    V = int(params["pos"].shape[0])
    P = int(static["indices"].shape[0])
    T, M = (int(s) for s in static["tile_pids"].shape)
    ts = 1 << cfg.tile_logsize
    pix = T * ts * ts
    hard = (not cfg.alpha_blend) and cfg.soft_edge_temp == 0
    K = 1 if hard else int(slots)
    textured = bool(cfg.textured)

    C_row = 27 if textured else 21        # (P, C) shade record row
    rec_row = C_row * 4
    vis_row = (9 + 3) * 4                 # edges + z per visibility step
    param_row = (4 + 4 + (2 if textured else 0)) * 4   # pos+color+uv
    tex_shape = params["tex"].shape
    tex_bytes = int(tex_shape[0]) * int(tex_shape[1]) * 16 if textured else 0

    t = {}
    # prim_setup: 3 corner gathers + setup/record writes
    t["setup_gather_bytes"] = 3 * P * param_row
    t["setup_write_bytes"] = P * (vis_row + rec_row)
    # visibility: dense (T, M) stream over the tile pid lists
    t["vis_record_read_bytes"] = T * M * vis_row
    t["vis_slot_write_bytes"] = pix * 4 * K
    # shade fwd: two-level record gather + per-pixel-slot row reads
    t["record_table_bytes"] = 2 * T * M * rec_row      # build rec_tile
    t["record_gather_bytes"] = K * pix * (rec_row + 4)  # row + idx
    t["texture_read_bytes"] = K * pix * 64 if textured else 0
    t["composite_bytes"] = (2 * K + 1) * pix * 16      # fb carry + image
    t["loss_read_bytes"] = 2 * pix * 16
    if fwd_bwd:
        # backward re-reads the forward streams (residual gathers) and
        # writes the transposed accumulations
        t["bwd_record_gather_bytes"] = K * pix * (rec_row + 4 + 16)
        t["bwd_record_table_grad_bytes"] = 2 * T * M * rec_row + P * rec_row
        t["bwd_texgrad_bytes"] = ((K * pix * (64 + 16)   # quad grads
                                   + 2 * tex_bytes * 4   # quad table fold
                                   + tex_bytes)
                                  if textured else 0)
        t["bwd_setup_transpose_bytes"] = P * (vis_row + rec_row) \
            + 3 * P * param_row + V * param_row
        t["bwd_composite_bytes"] = (2 * K + 1) * pix * 16
    if optimizer == "sgd":
        t["optimizer_bytes"] = 3 * (V * param_row + tex_bytes)
    # "bytes_total" deliberately does NOT match traffic_bytes()'s
    # `*_bytes` stream pattern (it would double-count)
    t["bytes_total"] = int(sum(v for k, v in t.items()
                               if k.endswith("_bytes")))
    t.update({"pixels": pix, "slots": K, "tiles": T, "prims": P,
              "tile_slots": M})
    return t


def drawcall_traffic(binned, render_state, counts: dict | None = None) -> dict:
    """Memory-traffic model for one binned drawcall.

    Mirrors what the reference's units issue per draw:
      raster: tile header (8B) + pid word (4B/pid) + 9 edge words per
              pid-reference (raster_unit.cpp:153-204) — exact from binning
      tex:    4 texel fetches per textured fragment (bilinear) or 1 (point)
      om:     conditional zbuf/cbuf read + write words (om_unit.cpp:85-136)

    counts: MEASURED fragment counts from
    ops.deferred.measure_drawcall_counts ({"fragments", "om_passing"}) —
    the emulator.cpp:416-545 measured-counter semantics: tex reads and OM
    reads are per covered fragment, OM writes per ds-passing fragment.
    Without counts, fragments fall back to the coverage-area upper bound
    (every pid covers its whole tile) and keys carry a ``_ub`` suffix.
    """
    om = render_state.om
    flags = render_state.flags
    num_tiles = binned.num_tiles
    total_pid_refs = int(binned.tile_pid_count.sum())

    raster_reads = num_tiles * 8 + total_pid_refs * (4 + 9 * 4)

    measured = counts is not None
    if measured:
        frags = int(counts["fragments"])
        passing = int(counts["om_passing"])
    else:
        ts = 1 << binned.tile_logsize
        # conservative fragment upper bound: every pid covers its whole tile
        frags = total_pid_refs * ts * ts
        passing = frags
    suffix = "" if measured else "_ub"

    if flags.tex_enabled and render_state.tex is not None:
        stride = C.TEX_FORMAT_STRIDE[render_state.tex.format]
        texels = 4 if render_state.tex.filter == C.TEX_FILTER_BILINEAR else 1
        tex_reads = frags * texels * stride
    else:
        tex_reads = 0

    depth_en = om.ds.depth_enabled
    stencil_en = om.ds.stencil_enabled(False) or om.ds.stencil_enabled(True)
    om_reads = frags * 4 * (
        (1 if (depth_en or stencil_en) else 0)
        + (1 if (om.color_write and om.blend.enabled) else 0))
    om_writes = passing * 4 * (
        (1 if (depth_en and om.depth_writemask) or stencil_en else 0)
        + (1 if om.color_write else 0))

    out = {
        "raster_mem_reads_bytes": raster_reads,
        f"tex_mem_reads_bytes{suffix}": tex_reads,
        f"om_mem_reads_bytes{suffix}": om_reads,
        f"om_mem_writes_bytes{suffix}": om_writes,
        "tiles": num_tiles,
        "prims": binned.num_prims,
    }
    if measured:
        out["fragments"] = frags
        out["om_write_fragments"] = passing
    else:
        out["fragments_upper_bound"] = frags
    return out
