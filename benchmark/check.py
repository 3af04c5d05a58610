"""The numbers that decide `correct`, each against its limit from the
cell's file under workloads/ (with the readings it was set from).

Inference: `worst_rmse_u8`, the largest over the sampled images of the
root-mean-square difference, in uint8 levels, between the fake_A the
timed path returned and the plain reference's (float32, TF32 off, the
same truncating uint8 conversion).

Training, from three steps of the program and of the reference on the
same weights and batches (relative gaps of readings, each against the
reference's reading of that item or the median item's, whichever is
larger):
  loss1    every loss term of step 1 (one weight state, one batch);
  loss23   every loss term of steps 2 and 3;
  fake1    the step-1 fakes of every branch (A, R, S), the worst image's
           RMS difference in uint8 levels (127.5 per unit of [-1, 1]);
  grad1    each leaf's gradient norm at step 1, as Adam got it
           (exp_avg / (1 - beta1) after one step), the worst leaf;
  grad1_med  the same gaps' median over the leaves: steady where a few
           small leaves (a 1-element bias) swing with bf16 rounding;
  dparam3  each leaf's ||p3 - p0|| after three steps, over the leaves the
           reference's step-1 gradient reaches (norm at least 1e-3 of the
           median leaf's: a leaf below that moves under Adam by
           round-off alone).
And from one more step of each, after the window, from the state the
program's window left (its weights and Adam moments):
  lossw    every loss term of that step;
  fakew    its fakes of every branch, as fake1;
  dparamw  each leaf's change over that step, over the leaves that
           step's reference gradient reaches, as dparam3;
  dparamw_med  the same gaps' median over those leaves: steady where a
           few leaves (CFS's squeeze layers in bf16) swing.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

GRAD_FLOOR = 1e-3


def worst_rmse_u8(got: dict, want: dict) -> float:
    """got {key: [arrays]}, want {key: array}, arrays [n, h, w, c]: the
    worst per-image root-mean-square difference (in uint8 levels when
    the arrays are uint8 images); an answer of another shape is wrong."""
    worst = 0.0
    for key, outs in got.items():
        ref = want[key].astype(np.float32)
        for out in outs:
            if out.shape != ref.shape:
                return math.inf
            d = out.astype(np.float32) - ref
            per = np.sqrt(np.mean(d * d, axis=tuple(range(1, d.ndim))))
            worst = max(worst, float(per.max()))
    return worst


def _gap(a: float, b: float, floor: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-30)


def _worst(got: dict, want: dict, keys=None) -> tuple:
    """(the worst relative gap, its key)."""
    keys = list(want) if keys is None else keys
    if not keys:
        return 0.0, None
    floor = statistics.median(abs(want[k]) for k in keys)
    return max(((_gap(got.get(k, math.nan), want[k], floor), k) for k in keys),
               key=lambda t: -math.inf if math.isnan(t[0]) else t[0])


def _moved(grad: dict) -> list:
    med = statistics.median(grad.values())
    return [k for k, v in grad.items() if v >= GRAD_FLOOR * med]


def _fake_gap(got: dict, want: dict) -> float:
    if not set(got) >= set(want):
        return math.inf
    return 127.5 * worst_rmse_u8({k: [got[k]] for k in want}, want)


def train_checks(got: dict, want: dict, look: bool = False) -> dict:
    """got, want: {"losses": [step dicts], "fake1": {name: NHWC array},
    "grad1": {leaf: norm}, "dparam3": {leaf: norm}, "after": {"losses":
    dict, "fake": {name: array}, "dparam": {leaf: norm}, and in want
    "grad": {leaf: norm}}}.  `look` adds the item each worst gap came
    from."""
    worst = {"loss1": _worst(got["losses"][0], want["losses"][0]),
             "loss23": max((_worst(g, w) for g, w in zip(got["losses"][1:],
                                                         want["losses"][1:])),
                           key=lambda t: t[0]),
             "grad1": _worst(got["grad1"], want["grad1"]),
             "dparam3": _worst(got["dparam3"], want["dparam3"],
                               _moved(want["grad1"]))}
    out = {"fake1": _fake_gap(got["fake1"], want["fake1"])}
    if "after" in want:
        g, w = got["after"], want["after"]
        moved = _moved(w["grad"])
        worst.update(lossw=_worst(g["losses"], w["losses"]),
                     dparamw=_worst(g["dparam"], w["dparam"], moved))
        out["fakew"] = _fake_gap(g["fake"], w["fake"])
        floor = statistics.median(abs(w["dparam"][k]) for k in moved)
        out["dparamw_med"] = statistics.median(
            _gap(g["dparam"].get(k, math.nan), w["dparam"][k], floor)
            for k in moved)
    out.update({k: v for k, (v, _) in worst.items()})
    floor = statistics.median(want["grad1"].values())
    out["grad1_med"] = statistics.median(
        _gap(got["grad1"].get(k, math.nan), v, floor)
        for k, v in want["grad1"].items())
    if look:
        out.update({f"{k}_at": at for k, (_, at) in worst.items()})
    return out


def norms(tensors: dict) -> dict:
    """{name: float norm} with one transfer to the host."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in names]).tolist()
    return dict(zip(names, vals))


def adam_grad1(leaves: dict, optimizers, beta1: float) -> dict:
    """Each leaf's step-1 gradient as Adam got it."""
    state = {}
    for opt in optimizers:
        state.update(opt.state)
    return norms({k: state[p]["exp_avg"] / (1.0 - beta1)
                  for k, p in leaves.items() if p in state})


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    holds a limit for: every one at or under it; one that is not finite
    fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = values[name]
        out[name] = {"value": v, "limit": lim}
        ok &= math.isfinite(v) and v <= lim
    return ok, out
