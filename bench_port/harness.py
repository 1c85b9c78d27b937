"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, the result line.

The cell, its configuration, its traffic and its limits are data, found by
name (``BENCHMARK.json``, ``configs/<config>.json``,
``workloads/<cell>.json``, ``limits/<cell>.json``); the per-layer metrics
are readers found by name (``metrics/<metric>.py``).  Two kinds of cell
exist, named by the traffic file's ``kind``:

- ``detect``: a closed loop of one caller.  Each call takes the next batch
  of the resident pool through ``FasterRCNN.detect`` and ``postprocess``
  under ``torch.inference_mode`` (the port's ``entry`` graph, eager, as a
  user calls it) and copies the ``Detections`` to the host; the next call
  is issued when they are there.
- ``train``: ``train_step`` on a ``TrainState`` (float32 master weights,
  compute in the configuration's dtype), one pool batch after another,
  with no read back to the host; the window ends with a synchronize.  Its
  first three steps are part of set-up, and the check follows them.

Set-up builds or loads the kernels, makes the weights and the pool from
the seed, builds the model and warms up the cell's one shape.  The harness
adds no ``torch.compile`` and no CUDA graph.  A traced run replaces the
measured window by the traffic file's ``trace_calls`` calls three times:
untraced (the pace), under the device pass and under the span pass
(:mod:`bench_port.trace`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from bench_port import check, counts, traffic
from bench_port import trace as tr
from bench_port import weights as wts
from bench_port.reference import boxes as rb
from bench_port.reference import nets
from bench_port.reference import train as rt

HERE = Path(__file__).resolve().parent
CHECK_STEPS = 3
# a seed of up to 2**31 (and a little more) keeps (seed << 32) + step in the
# 64 bits a generator's seed holds
TRAIN_SEED_MOD = 2 ** 31


class Cell(NamedTuple):
    """A cell's files, and the metrics it reports as {name: unit}."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: Dict[str, str]
    per_layer: Dict[str, str]
    bench_dir: Path = HERE


def load_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, and the
    metrics it reports: the end-to-end metrics without a ``workloads`` key
    or listing it, the per-layer metrics listing it or, without the key,
    moving one of its end-to-end metrics."""
    with open(root / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cell = next((c for c in manifest["workloads"] if c["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        traffic_params = json.load(f)
    e2e = {m["name"]: m["unit"] for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    per_layer = {m["name"]: m["unit"] for m in manifest["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m
                                                       and m["moves"] in e2e)}
    return Cell(name, int(cell["chips"]), config, traffic_params,
                check.load_limits(bench_dir / "limits" / f"{name}.json"), e2e, per_layer,
                bench_dir)


def _replace(obj, overrides: Mapping):
    import dataclasses

    kw = {}
    for k, v in overrides.items():
        cur = getattr(obj, k)
        kw[k] = _replace(cur, v) if dataclasses.is_dataclass(cur) else (
            tuple(v) if isinstance(v, list) else v)
    return dataclasses.replace(obj, **kw)


def model_config(config: Mapping):
    """The port's FasterRCNNConfig of a configuration file: the preset,
    its backbone and RoI mode, then any ``overrides`` (nested by field)."""
    from trcnn_torch.config import coco_config, voc_config

    cfg = {"voc": voc_config, "coco": coco_config}[config["preset"]]()
    cfg = _replace(cfg, {"backbone": config["backbone"], "roi": {"mode": config["roi_mode"]}})
    return _replace(cfg, config.get("overrides", {}))


def shapes(cfg, batch: int) -> counts.Shapes:
    return counts.Shapes(cfg.backbone, batch, cfg.image.pad_h, cfg.image.pad_w,
                         cfg.proposals.post_nms_topk_test, cfg.proposal_targets.rois_per_image,
                         cfg.num_classes, cfg.head_hidden, cfg.rpn_channels, nets.crop_size(cfg),
                         nets.FEAT_CHANNELS[cfg.backbone], cfg.anchors.num_anchors,
                         cfg.anchors.feat_stride)


def trace_counts(cfg, kind: str, batch: int) -> Dict[str, object]:
    s = shapes(cfg, batch)
    return {"kind": kind,
            "flops_per_call": counts.detect_flops(s) if kind == "detect" else
            counts.train_flops(s),
            "k3": counts.stem_bound(s) if cfg.backbone == "vgg16" else None,
            "k5": counts.roi_align_bound(s) if cfg.roi.mode == "align" else None,
            "k6": counts.roi_align_bwd_bound(s) if cfg.roi.mode == "align" else None}


def read_metrics(names, tr_: tr.Trace, bench_dir: Path = HERE) -> Dict[str, float]:
    """Each named reader (``metrics/<name>.py``'s ``read``) on the trace;
    a reader that finds nothing returns None and its metric is left out."""
    out = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                      bench_dir / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(tr_)
        if value is not None:
            out[name] = float(value)
    return out


def make_weights(cfg, seed: int, pool, device) -> Dict[str, torch.Tensor]:
    w = wts.make(nets.param_spec(cfg), seed, device)
    first = pool[0]
    wts.calibrate(w, cfg, first["images"][:2], first["im_info"][:2])
    return w


def build_model(cfg, config: Mapping, w: Mapping[str, torch.Tensor], kind: str, device,
                quant: str = "none"):
    """The port's model over weights ``w``; for detect cast for serving as
    the port's ``entry`` does."""
    from trcnn_torch.models import faster_rcnn

    dtype = getattr(torch, config["dtype"])
    model = faster_rcnn.make_model(cfg, dtype=dtype, device=device, quant=quant)
    model.load_state_dict(w, strict=True)
    if kind == "detect":
        if quant == "none":
            faster_rcnn.cast_params_for_inference(model, dtype)
        model.eval()
    return model


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def detect_call(model, batch, cfg):
    """One call as a user makes it: detect, postprocess, the detections
    copied to the host.  Returns (raw, host detections)."""
    from trcnn_torch.models import faster_rcnn

    with torch.inference_mode():
        raw = model.detect(batch["images"], batch["im_info"])
        dets = faster_rcnn.postprocess(raw, batch["im_info"], cfg)
        return raw, tuple(t.cpu() for t in dets)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def detect_window(model, pool, cfg, seconds: float, max_calls: Optional[int], check_at: int,
                  device, span_hooks: bool = False, crop_image: int = 0) -> dict:
    """Calls until ``seconds`` have passed (or ``max_calls`` were made),
    call ``check_at`` captured for the check (the crops of its image
    ``crop_image``)."""
    cap = check.DetectCapture(crop_image)
    hooks = tr.SpanHooks({"bench.trunk": model.extractor, "bench.head": model.head}) \
        if span_hooks else None
    lat, i = [], 0
    t_start = time.perf_counter()
    t1 = t_start
    while (max_calls is None and t1 - t_start < seconds) or (max_calls is not None
                                                            and i < max_calls):
        batch = pool[i % len(pool)]
        handles = cap.hooks(model) if i == check_at else []
        t0 = time.perf_counter()
        raw, dets = detect_call(model, batch, cfg)
        t1 = time.perf_counter()
        for h in handles:
            h.remove()
        if i == check_at:
            cap.raw, cap.dets, cap.index = raw, dets, i % len(pool)
        lat.append(t1 - t0)
        i += 1
    if hooks is not None:
        hooks.remove()
    return {"calls": i, "window_s": t1 - t_start, "latencies": lat, "capture": cap}


def train_window(state, pool, seconds: float, max_steps: Optional[int], seed: int, device
                 ) -> dict:
    from trcnn_torch.train import step as step_mod

    i = 0
    t_start = time.perf_counter()
    while (max_steps is None and time.perf_counter() - t_start < seconds) or (
            max_steps is not None and i < max_steps):
        step_mod.train_step(state, pool[(CHECK_STEPS + i) % len(pool)], seed)
        i += 1
    _sync(device)
    return {"calls": i, "window_s": time.perf_counter() - t_start}


@contextlib.contextmanager
def _nothing():
    yield []


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _checked(compute, result: dict) -> Dict[str, float]:
    """The check's numbers; a check that fails to run reads as not correct
    (``check_error``, which has no limit), its error kept in the result."""
    try:
        return compute()
    except Exception as e:                     # the run still reports, as not correct
        traceback.print_exc()
        result["check_error"] = f"{type(e).__name__}: {e}"[:500]
        return {"check_error": 1.0}


def train_check(cfg, dtype: str, w_host, batches, rpn_out, port_losses, momentum, p3, seed,
                device, result: dict) -> Dict[str, float]:
    """The reference's first three steps from the run's weights, on the
    port's proposals of each step (re-derived from its RPN outputs), against
    the port's losses, first gradient and change."""
    w_ref = {k: v.to(device, copy=True) for k, v in w_host.items()}
    props = [rb.proposals(fg, dl, b["im_info"], cfg, train=True)
             for (fg, dl), b in zip(rpn_out, batches)]
    with nets.float32_exact():
        ref_losses, ref_grad = rt.run_steps(w_ref, cfg, batches, props, seed,
                                            getattr(torch, dtype))
    ref_change = {k: w_ref[k].to("cpu", copy=True) - w_host[k] for k in w_host}
    port_grad = check.port_first_gradient(momentum, w_host, cfg.optim)
    port_change = {k: p3[k] - w_host[k] for k in w_host}
    numbers, worst = check.train_numbers(port_losses, port_grad, port_change, ref_losses,
                                         {k: g.cpu() for k, g in ref_grad.items()},
                                         ref_change, cfg.backbone)
    result["worst_leaf"] = worst
    return numbers


def run(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_process: Optional[float] = None, trace_path: Optional[str] = None) -> dict:
    """One run; returns the result object (without the card's description)."""
    t_setup = time.perf_counter() if t_process is None else t_process
    from trcnn_torch import _build

    if torch.device(device).type == "cuda":
        _build.timed_build()
    cfg = model_config(cell.config)
    t = cell.traffic
    kind = t["kind"]
    batch = int(cell.config["batch_size"])
    pool = traffic.make_pool(t, cfg, batch, int(cell.config.get("gt_capacity", 0)), seed,
                             device)
    w = make_weights(cfg, seed, pool, device)
    w_host = {k: v.to("cpu", copy=True) for k, v in w.items()}
    model = build_model(cfg, cell.config, w, kind, device)
    del w
    rng = np.random.default_rng(seed)
    result: dict = {"traffic": traffic.summary(pool)}
    train_seed = seed % TRAIN_SEED_MOD
    if kind == "detect":
        for i in range(int(t.get("warmup_calls", 3))):
            detect_call(model, pool[i % len(pool)], cfg)
        _sync(device)
        within = int(t["trace_calls"]) if traced else int(t["check"]["within"])
        check_at = int(rng.integers(0, within))
        crop_image = int(rng.integers(0, batch))
        setup_s = time.perf_counter() - t_setup
        _reset_peak(device)
        n = int(t["trace_calls"]) if traced else None
        if traced:
            pace = detect_window(model, pool, cfg, seconds, n, -1, device)
        with tr.profiled(trace_path, host=False) if traced else _nothing() as events:
            win = detect_window(model, pool, cfg, seconds, n, check_at, device,
                                crop_image=crop_image)
        peak = _peak(device)
        if traced:
            with tr.profiled(trace_path, host=True) as span_events:
                span_win = detect_window(model, pool, cfg, seconds, n, -1, device,
                                         span_hooks=True)
        cap = win["capture"]
        checked = pool[cap.index] if cap.raw is not None else None
        del model, pool
        _free(device)
        t_check = time.perf_counter()
        if checked is None:
            numbers = {"checked_call_reached": 0.0}
        else:
            result["checked"] = {"call": check_at, "detections": int(cap.dets[3].sum())}
            numbers = _checked(lambda: check.detect_numbers(
                cap, checked["images"], checked["im_info"],
                {k: v.to(device, copy=True) for k, v in w_host.items()}, cfg), result)
        lat = win["latencies"]
        e2e = {"detect_img_per_s": batch * win["calls"] / win["window_s"],
               "detect_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    else:
        from trcnn_torch.train import step as step_mod

        state = step_mod.TrainState.create(model)
        rpn_out: List = []
        handle = model.rpn.register_forward_hook(
            lambda _m, _a, out: rpn_out.append((out.fg_probs.detach().clone(),
                                                out.deltas.detach().clone())))
        port_losses, momentum = [], None
        for s in range(CHECK_STEPS):
            m = step_mod.train_step(state, pool[s], train_seed)
            port_losses.append({k: float(v) for k, v in m.items()})
            if s == 0:
                momentum = {k: v.to("cpu", copy=True) for k, v in state.optimizer.momentum.items()}
        handle.remove()
        result["checked"] = {"losses": [m["loss"] for m in port_losses]}
        p3 = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
        for i in range(int(t.get("warmup_steps", 1))):
            step_mod.train_step(state, pool[CHECK_STEPS + i], train_seed)
        _sync(device)
        setup_s = time.perf_counter() - t_setup
        _reset_peak(device)
        n = int(t["trace_calls"]) if traced else None
        if traced:
            pace = train_window(state, pool, seconds, n, train_seed, device)
        with tr.profiled(trace_path, host=False) if traced else _nothing() as events:
            win = train_window(state, pool, seconds, n, train_seed, device)
        peak = _peak(device)
        if traced:
            with tr.profiled(trace_path, host=True) as span_events:
                span_win = train_window(state, pool, seconds, n, train_seed, device)
        checked = pool[:CHECK_STEPS]
        del state, model, pool
        _free(device)
        t_check = time.perf_counter()
        numbers = _checked(lambda: train_check(
            cfg, cell.config["dtype"], w_host, checked, rpn_out, port_losses, momentum, p3,
            train_seed, device, result), result)
        e2e = {"train_img_per_s": batch * win["calls"] / win["window_s"]}
    e2e["peak_mem_gib"] = peak / 2 ** 30
    e2e["setup_s"] = setup_s
    result.setdefault("checked", {})["check_s"] = time.perf_counter() - t_check
    correct, rows, readings = check.judge(numbers, cell.limits)
    result.update({"correct": correct, "attempted": win["calls"], "failed": 0,
                   "memory_peak_bytes": peak, "window_s": win["window_s"], "checks": rows,
                   "readings": readings})
    if traced:
        trace = tr.Trace(events, win["calls"], win["window_s"], span_events, span_win["calls"],
                         trace_counts(cfg, kind, batch), pace["window_s"] / pace["calls"])
        result["metrics"] = {k: {"value": v, "unit": cell.per_layer[k]}
                             for k, v in read_metrics(cell.per_layer, trace,
                                                      cell.bench_dir).items()}
        result["busy_s"] = tr.busy_us(trace) / 1e6
        result["breakdown"] = tr.breakdown(trace)
    else:
        result["metrics"] = {k: {"value": e2e[k], "unit": unit}
                             for k, unit in cell.end_to_end.items() if k in e2e}
    return result
