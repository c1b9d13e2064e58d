"""Pipeline-schedule pebble graphs from the executable simulator — the
port's counterpart of `scripts/plot_schedule.py`, with the same flags
and the same output letter for letter, drawn from this package's
`parallel.schedules` and `parallel.verify` (`simulate`,
`interleaved_tables`, `zb_tables`): the tables the port's pipeline
engine executes. Host code only; nothing runs on a device.

    python -m shallowspeed_tpu_torch.plot_schedule [--pp 4] [--n-mu 8]
        [--virtual-pp 2] [--svg out.svg]

Prints an ASCII pebble graph per schedule (stages x rounds, F<mu> /
B<mu> cells, B<mu>w for zero-bubble's weight-gradient ops) with its
makespan, bubble fraction and peak stash, and with `--svg` writes them
stacked into one SVG.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

from shallowspeed_tpu_torch.parallel.schedules import (GPipeSchedule,
                                                       InferenceSchedule,
                                                       NaiveParallelSchedule,
                                                       PipeDreamSchedule)
from shallowspeed_tpu_torch.parallel.verify import (interleaved_tables,
                                                    simulate, zb_tables)

SCHEDULES = [
    ("naive", NaiveParallelSchedule, True),
    ("gpipe", GPipeSchedule, True),
    ("1f1b (PipeDream-Flush)", PipeDreamSchedule, True),
    ("inference", InferenceSchedule, False),
]


def cells(report) -> dict:
    """(stage, round) -> label of the simulator's round maps."""
    grid = {}
    for (s, mu), r in report.fwd_rounds.items():
        grid[(s, r)] = f"F{mu}"
    for (s, mu), r in report.bwd_rounds.items():
        grid[(s, r)] = f"B{mu}"
    return grid


def ascii_graph(name, report, pp, n_mu) -> str:
    """The report's pebble graph: a header line, then one row a stage.
    The bubble is read off the grid (the interleaved and zero-bubble
    panels do not run 2 n_mu ops a stage)."""
    grid = cells(report)
    span = report.makespan
    work = max((sum(1 for (st, _) in grid if st == s)
                for s in range(pp)), default=0)
    bubble = 1.0 - work / span if span else 0.0
    out = [f"{name}  pp={pp}  n_mu={n_mu}  makespan={span} rounds  "
           f"bubble={bubble:.0%}  peak stash={report.peak_stash}"]
    for s in range(pp):
        row = "".join(f"{grid.get((s, r), '.'):>4}" for r in range(span))
        out.append(f"  stage {s} |{row}")
    return "\n".join(out)


def svg_graph(reports, pp, n_mu, path) -> None:
    """Every (name, report) stacked in one SVG: forwards in blues,
    backwards in oranges, weight-gradient ops in greens, shaded by
    microbatch."""
    cw, ch, pad, gap = 26, 18, 6, 34
    span_max = max(r.makespan for _, r in reports)
    width = pad * 2 + 70 + span_max * cw
    height = pad + sum(gap + pp * ch + pad for _ in reports)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" font-family="monospace" font-size="11">']
    y = pad
    for name, rep in reports:
        parts.append(f'<text x="{pad}" y="{y + 12}">{name}  '
                     f'(makespan {rep.makespan}, peak stash '
                     f'{rep.peak_stash})</text>')
        y += gap - 14
        grid = cells(rep)
        for s in range(pp):
            for r in range(rep.makespan):
                lab = grid.get((s, r))
                x = pad + 70 + r * cw
                yy = y + s * ch
                if lab:
                    m = re.match(r"[FB](\d+)", lab)
                    mu = int(m.group(1)) if m else 0
                    shade = 35 + int(45 * (mu / max(1, n_mu - 1)))
                    hue = 210 if lab[0] == "F" else 25
                    if lab.endswith("w"):
                        hue = 130
                    parts.append(
                        f'<rect x="{x}" y="{yy}" width="{cw - 2}" '
                        f'height="{ch - 2}" fill="hsl({hue},70%,{shade}%)"/>')
                    parts.append(
                        f'<text x="{x + 3}" y="{yy + 13}" '
                        f'fill="white">{lab}</text>')
                else:
                    parts.append(
                        f'<rect x="{x}" y="{yy}" width="{cw - 2}" '
                        f'height="{ch - 2}" fill="#eee"/>')
            parts.append(f'<text x="{pad}" y="{y + s * ch + 13}">'
                         f'stage {s}</text>')
        y += pp * ch + pad
    parts.append("</svg>")
    Path(path).write_text("\n".join(parts))


class _Grid:
    """A table's ops in the simulator report's shape (`cells` reads
    it)."""

    def __init__(self, makespan, peak_stash):
        self.makespan, self.peak_stash = makespan, peak_stash
        self.fwd_rounds, self.bwd_rounds = {}, {}


def interleaved_report(n_mu, pp, vpp) -> _Grid:
    """The interleaved-1F1B panel from `interleaved_tables`, the tables
    the vpp x 1f1b engine follows: chunk v's ops carry v apostrophes
    after the microbatch, so the chunks stay apart on the graph."""
    tb = interleaved_tables(n_mu, pp, vpp)
    rep = _Grid(tb.n_rounds, [tb.n_stash_slots] * pp)
    for r in range(tb.n_rounds):
        for d in range(pp):
            op, v, mu = tb.op[r, d], tb.chunk[r, d], tb.mu[r, d]
            if op == 0:
                continue
            target = rep.fwd_rounds if op == 1 else rep.bwd_rounds
            target[(d, f"{mu}" + "'" * int(v))] = r
    return rep


def zb_report(n_mu, pp) -> _Grid:
    """The ZB-H1 panel from `zb_tables`, the rows the zb engine runs; its
    stash is the peak over the three pools (the B and W residuals and
    the B -> W cotangents), W ops drawn as B<mu>w."""
    tb = zb_tables(n_mu, pp)
    rep = _Grid(tb.n_rounds,
                [tb.n_resb_slots + tb.n_resw_slots + tb.n_tap_slots] * pp)
    for r in range(tb.n_rounds):
        for d in range(pp):
            op, mu = int(tb.op[r, d]), int(tb.mu[r, d])
            if op == 1:
                rep.fwd_rounds[(d, f"{mu}")] = r
            elif op == 2:
                rep.bwd_rounds[(d, f"{mu}")] = r
            elif op == 3:
                rep.bwd_rounds[(d, f"{mu}w")] = r
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--n-mu", type=int, default=8)
    ap.add_argument("--virtual-pp", type=int, default=2,
                    help="chunk count for the interleaved-1F1B panel "
                         "(0/1 = skip; needs n_mu, pp from above)")
    ap.add_argument("--svg", type=str, default="",
                    help="also write a stacked SVG to this path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    reports = []

    def show(name, rep):
        reports.append((name, rep))
        print(ascii_graph(name, rep, args.pp, args.n_mu))
        print()

    for name, cls, training in SCHEDULES:
        show(name, simulate(cls, args.n_mu, args.pp, training=training))
    if args.virtual_pp > 1:
        show(f"interleaved 1f1b (vpp={args.virtual_pp}; chunk>=1 "
             f"marked ')",
             interleaved_report(args.n_mu, args.pp, args.virtual_pp))
    show("ZB-H1 zero-bubble (W ops marked w)", zb_report(args.n_mu, args.pp))
    if args.svg:
        svg_graph(reports, args.pp, args.n_mu, args.svg)
        print(f"wrote {args.svg}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
