"""Dry run of the paper's own programs on the production mesh, on the
meta device.

    PYTHONPATH=src python -m repro_torch.launch.collab_dryrun \\
        [--multi-pod] [--image-size 64] [--batch 256] [--t-cut 200] \\
        [--T 1000] [--clients 4] [--round-batches 2]

The port of the JAX package's ``launch/collab_dryrun.py``, with its flags
and defaults: six programs of CollaFuse with the U-Net (the reference's
width-128 config, float32), each run once as rank 0 runs it on the
``meta`` device over a fake process group (launch/dryrun.py, whose
``measure`` and fields it shares, ``trace_s`` in place of JAX's
``compile_s``):

* ``collab_train_step``: one Alg.-1 step (client losses and AdamW, then
  the server's loss from the re-noised payload and AdamW), the batch over
  ("pod", "data"), the models replicated;
* ``server_denoise``: one Alg.-2 server pass (the T - t_cut steps, each a
  keyed DDPM step);
* ``vectorized_round`` / ``ragged_round`` / ``train_runtime``: one round
  of k client slots on a ``("clients", "data")`` mesh — dense, masked,
  and identity-keyed over a cohort's uids;
* ``vectorized_sample``: the batched engine over a plan of k + 1 requests
  (GM, ICM and two collaborative cuts, plus one deduplicated duplicate).

Host masks, uids and the plan's ``request_client`` stay host arrays, as
the port's round and engine take them.  The port's round and engine run
every slot and group in one process, so the census is empty and the
record says ``"partitioner": null``.  The record goes to
``<out>/collafuse_unet__<mesh>.json``.

``collab_step_program`` builds the first program at any batch on any
device, so that chip_smoke.py can hold the meta counts of one U-Net step
(group norm and the cached output shapes of launch/dryrun.py's
``StepCounters``) against the card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.ddpm_unet import CONFIG
from repro_torch.core import prng
from repro_torch.core.collab import make_vectorized_round
from repro_torch.core.protocol import make_collab_step
from repro_torch.core.sample_plan import (PlanTables, SampleRequest,
                                          plan_requests)
from repro_torch.core.sampler import make_sample_engine, server_denoise
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import UNet, unet_apply
from repro_torch.launch.dryrun import (OUT_DIR, device_bytes, measure,
                                       mesh_tag, run_operands, whole)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import specs as S


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--t-cut", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--round-batches", type=int, default=2)
    ap.add_argument("--out", default=OUT_DIR)
    return ap.parse_args(argv)


def unet_config(image_size: int):
    """The reference dry run's U-Net: width 128, float32, at
    ``image_size``."""
    return dataclasses.replace(
        CONFIG, image_size=image_size, base_width=128,
        width_mults=(1, 2, 2, 4), attn_resolutions=(16,), time_dim=512,
        dtype="float32")


def collab_step_program(image_size: int, batch: int, T: int, t_cut: int,
                        device):
    """``collab_train_step``'s function and operands on ``device`` for
    ``batch`` images: a client and a server U-Net (torch's own
    initialisation), their AdamW states, zero images and labels, key 0."""
    ucfg = unet_config(image_size)
    with torch.device(device):
        client, server = UNet(ucfg), UNet(ucfg)
        x0 = torch.zeros(batch, image_size, image_size, 3)
        y = torch.zeros(batch, ucfg.n_classes)
    step = make_collab_step(
        DiffusionSchedule.linear(T, device=device), CutPoint(T, t_cut),
        lambda p, x, t, yy: unet_apply(p, x, t, yy, ucfg),
        AdamWConfig(lr=1e-3))
    return step, (client, init_opt_state(client), server,
                  init_opt_state(server), x0, y,
                  prng.PRNGKey(0, device=device))


def _meta_unet(ucfg):
    with torch.device("meta"):
        return UNet(ucfg)


def _abstract_model(ucfg):
    """A meta U-Net, its parameters replicated."""
    model = _meta_unet(ucfg)
    for p in model.parameters():
        p.spec = (None,) * p.ndim
    return model


def _opt(model, mesh):
    """A meta AdamW state of ``model`` (float32 moments, a host step),
    replicated on ``mesh``."""
    moments = {n: torch.empty(p.shape, device="meta")
               for n, p in model.named_parameters()}
    specs = {n: (None,) * t.ndim for n, t in moments.items()}
    out = S.with_sharding({"m": moments, "v": moments},
                          {"m": specs, "v": specs}, mesh)
    out["step"] = torch.zeros((), dtype=torch.int32)
    out["step"].spec = ()
    return out


def _record(name, fn, args, parts, mesh) -> dict:
    per_part = {k: device_bytes(v, mesh) for k, v in parts.items()}
    per_part["total"] = sum(per_part.values())
    rec = measure(fn, args)
    rec.update(bytes_per_device=per_part,
               saved_activation_bytes=rec.pop("saved_activation_bytes"),
               partitioner=None)
    print(name, json.dumps({k: rec[k] for k in (
        "trace_s", "flops", "saved_activation_bytes", "collectives")}))
    print("  bytes_per_device:", per_part)
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    k = args.clients
    n_dev = 512 if args.multi_pod else 256
    ucfg = unet_config(args.image_size)
    if n_dev % k or ucfg.base_width % k:
        raise SystemExit(
            f"--clients {k}: must divide the device count ({n_dev}) and the "
            f"UNet base width ({ucfg.base_width}), as the reference's "
            "sharded client axis must tile the channel blocks (powers of "
            "two here).")
    mesh = make_production_mesh(args.multi_pod)
    baxes = S.mesh_batch_axes(mesh)
    sched = DiffusionSchedule.linear(args.T, device="meta")
    cut = CutPoint(args.T, args.t_cut)
    apply_fn = lambda p, x, t, y: unet_apply(p, x, t, y, ucfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    H, nc = args.image_size, ucfg.n_classes
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device="meta")

    # --- one Alg.-1 step and one server pass on ("data", "model") ------
    server, client = _abstract_model(ucfg), _abstract_model(ucfg)
    sopt, copt = _opt(server, mesh), _opt(client, mesh)
    batch = S.with_sharding(
        {"x0": meta(args.batch, H, H, 3), "y": meta(args.batch, nc),
         "key": meta(2, dtype=torch.int64)},
        {"x0": (baxes, None, None, None), "y": (baxes, None), "key": (None,)},
        mesh)
    run = run_operands(batch, mesh)
    collab_step = make_collab_step(sched, cut, apply_fn, opt_cfg)
    b_loc = run["x0"].shape[0]

    # --- the vectorized round on a ("clients", "data") mesh -------------
    cmesh = init_device_mesh("cpu", (k, n_dev // k),
                             mesh_dim_names=(S.CLIENT_AXIS, "data"))
    slots = [_meta_unet(ucfg) for _ in range(k)]
    stacked = {n: meta(k, *p.shape) for n, p in slots[0].named_parameters()}
    cstack = S.with_sharding(stacked, S.client_stacked_specs(stacked), cmesh)
    cspecs = S.client_opt_specs(stacked)
    cstate = S.with_sharding({"m": stacked, "v": stacked, "step":
                              meta(k, dtype=torch.int32)}, cspecs, cmesh)
    csopt = [whole(_opt(m, cmesh)) for m in slots]
    rserver = _abstract_model(ucfg)
    rsopt = _opt(rserver, cmesh)
    per_client_b = max(args.batch // k, 1)
    nb = args.round_batches
    stacks = S.with_sharding(
        {"xs": meta(nb, k, per_client_b, H, H, 3),
         "ys": meta(nb, k, per_client_b, nc),
         "mask": meta(nb, k, per_client_b),
         "uids": meta(k, dtype=torch.int32)},
        {"xs": (None, S.CLIENT_AXIS, "data", None, None, None),
         "ys": (None, S.CLIENT_AXIS, "data", None),
         "mask": (None, S.CLIENT_AXIS, "data"),
         "uids": S.cohort_uid_spec()}, cmesh)
    rstacks = run_operands(stacks, cmesh)
    mask = np.ones(tuple(rstacks["mask"].shape), np.float32)
    uids = np.arange(k, dtype=np.int64)
    ckey = meta(2, dtype=torch.int64)
    round_fn = make_vectorized_round(sched, cut, apply_fn, opt_cfg,
                                     masked=False)
    masked_fn = make_vectorized_round(sched, cut, apply_fn, opt_cfg,
                                      masked=True)
    cohort_fn = make_vectorized_round(sched, cut, apply_fn, opt_cfg,
                                      masked=True, identity_keyed=True)
    round_parts = {"params": [cstack, rserver],
                   "opt_state": [cstate, rsopt],
                   "batch": [stacks["xs"], stacks["ys"]]}
    ragged_parts = dict(round_parts, batch=[stacks["xs"], stacks["ys"],
                                            stacks["mask"]])
    cohort_parts = dict(round_parts, batch=[stacks[n] for n in (
        "xs", "ys", "mask", "uids")])

    # --- the batched sampling engine: k + 1 requests, mixed cuts ---------
    cut_menu = [args.t_cut, max(args.t_cut // 2, 1), 0, args.T]
    reqs = []
    for c in range(k):
        yy = np.zeros((per_client_b, nc), np.float32)
        yy[:, c % nc] = 1.0
        reqs.append(SampleRequest(client=c, t_cut=cut_menu[c % len(cut_menu)],
                                  y=yy))
    reqs.append(SampleRequest(client=0, t_cut=reqs[0].t_cut, y=reqs[0].y))
    plan = plan_requests(reqs, args.T, n_clients=k)
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in plan.tables]
    tables = S.with_sharding(PlanTables(*host),
                             S.sample_plan_specs(plan.tables), cmesh)
    run_tables = PlanTables(*[
        np.asarray(a) if name == "request_client" else
        torch.empty(a.shape, dtype=a.dtype, device="meta")
        for name, a in zip(PlanTables._fields, host)])
    engine = make_sample_engine(sched, apply_fn, (H, H, 3))

    results = {}
    for name, fn, fargs, parts, fmesh in (
        ("collab_train_step", collab_step,
         (client, whole(copt), server, whole(sopt), run["x0"], run["y"],
          run["key"]),
         {"params": [client, server], "opt_state": [copt, sopt],
          "batch": batch}, mesh),
        ("server_denoise",
         lambda p, key, y: server_denoise(p, key, y, (b_loc, H, H, 3), sched,
                                          cut, apply_fn),
         (server, run["key"], run["y"]),
         {"params": server, "batch": [batch["y"], batch["key"]]}, mesh),
        ("vectorized_round", round_fn,
         (slots, csopt, rserver, whole(rsopt), rstacks["xs"], rstacks["ys"],
          ckey), round_parts, cmesh),
        ("ragged_round", masked_fn,
         (slots, csopt, rserver, whole(rsopt), rstacks["xs"], rstacks["ys"],
          mask, ckey), ragged_parts, cmesh),
        ("train_runtime", cohort_fn,
         (slots, csopt, rserver, whole(rsopt), rstacks["xs"], rstacks["ys"],
          mask, uids, ckey), cohort_parts, cmesh),
        ("vectorized_sample", engine,
         (rserver, slots, ckey, run_tables),
         {"params": [rserver, cstack], "batch": list(tables)}, cmesh),
    ):
        results[name] = _record(name, fn, fargs, parts, fmesh)

    tag = "collafuse_unet__" + mesh_tag(args.multi_pod)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump({"tag": tag, "unet": dataclasses.asdict(ucfg),
                   "T": args.T, "t_cut": args.t_cut, "batch": args.batch,
                   "n_devices": n_dev, "results": results}, f, indent=1)
    print("saved", tag)
    return results


if __name__ == "__main__":
    main()
