"""Dry run of every parallel mode the port ships, on N ranks at tiny shapes.

    python -m anatomix_tpu_torch.parallel.dryrun --n N [--device cpu]

The counterpart of the JAX package's `dryrun_multichip` (`__graft_entry__.
py:58-230`), at the same shapes, on N spawned ranks (`parallel/launch`:
NCCL with one card a rank, or gloo on the CPU). Each phase is held against
the same computation on one rank, which every rank also runs:

1. the data-parallel pretraining step of the 6M topology (2 downs, ngf 4,
   crop 16, one view pair a rank) against the single-device step on the
   global batch;
2. the spatially sharded forward on a 2-D ('data', 'space') mesh (space 2
   when N is even) against the unsharded forward;
3. the window-sharded sliding window (roi 8, overlap 0.5, sw_batch 2) of
   that UNet against the unsharded stitch;
4. the same for a tiny Primus ViT (embed 48, 2 blocks, 4 heads, 16^3
   windows);
5. the data-parallel step of the dev topology (instance norm, Avg pool,
   trilinear) against the single-device step;
6. with `--train`, the trainer (`pretraining/train.train`) at the 6M
   topology's tiny config: 2 steps of a global batch of N items with
   validation at step 2, over N spawned ranks (`data_parallel_devices=N`)
   against one device;
7. the data-parallel step of that tiny ViT (`netG="primus"`: the v2
   tokenizer, and v1's patch embed at patch 4) against the single-device
   step on the global batch.

It prints `dryrun_multichip(N) ok: ...` with each loss's relative
distance from its single-device run (and a `trainer ok` line after phase
6) and exits 0, or raises with the failing rank's traceback.

On the CPU every path computes in f32 and is held to 1e-5 (relative, the
losses) and 1e-4 (absolute, the features), the trainer's losses to 1e-4.
On the card the kernels compute in bf16; the tolerances there come from
runs at world 1 and on four H100s, where the losses and the sharded
features equaled one card's bit for bit (held to 1e-6: relative for the
losses, mean |err| over the std for the features) and the trainer's
step-2 loss read 3.7e-4 from one card's (held to 2e-3). The stitch sums
in f32 on both routes and is held to 1e-4 of the features' largest value
(read: 1.6e-7). The ViT's mesh step (phase 7) is held to the same 1e-6:
at world 1 both its losses equaled the unsharded step's bit for bit, on
four H100s its v2 loss did and its v1 loss read 6.1e-8 from it (one f32
ulp).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from anatomix_tpu_torch.extract import make_feature_extractor
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.vit3d import (
    Primus,
    PrimusConfig,
    init_primus_params,
)
from anatomix_tpu_torch.ops.sliding_window import sliding_window_inference
from anatomix_tpu_torch.parallel.launch import spawn
from anatomix_tpu_torch.parallel.mesh import (
    data_mesh,
    shard_batch,
    space_mesh,
)
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.train import train
from anatomix_tpu_torch.pretraining.train_step import (
    build_train_step,
    init_train_state,
)

TINY = dict(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4)
TINY_DEV = dict(TINY, norm="instance", pooling="Avg", interp="trilinear",
                norm_eps=1e-2)
TINY_VIT = PrimusConfig(
    input_channels=1, num_classes=4, embed_dim=48, eva_depth=2,
    eva_numheads=4, patch_embed_size=(8, 8, 8), input_shape=(16, 16, 16),
    num_register_tokens=2, qk_norm=True, out_norm="demean",
    out_norm_eps=1e-2, in_eps=1e-2, tokenizer_base_features=8)
# v1's patch embed at patch 4: the L-c1 + L chain, the stage decoder's L and
# L-il exit
TINY_VIT1 = dataclasses.replace(TINY_VIT, version="v1",
                                patch_embed_size=(4, 4, 4))
# (f32 on the CPU, bf16 kernels on the card; see the module docstring)
TOL_LOSS = {torch.float32: 1e-5, torch.bfloat16: 1e-6}
TOL_FEATS = {torch.float32: 1e-4, torch.bfloat16: 1e-6}
TOL_STITCH = 1e-4
# the trainer's losses after a step: Adam's first update moves each weight
# by about lr whatever its gradient's size, so a gradient near 0 that the
# reduce order moves moves its weight by up to 2 lr
TOL_TRAIN = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


def _compute_dtype(dev: torch.device) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _feature_err(got, ref, cd) -> float:
    """max |err| (f32) or mean |err| / std (bf16) of the features."""
    got, ref = got.float(), ref.float()
    if cd == torch.float32:
        return float((got - ref).abs().max())
    return float((got - ref).abs().mean() / (ref.std() + 1e-8))


def dp_step_losses(config, mesh, dev, views, segs, seed: int):
    """(the data-parallel step's loss, the single-device step's loss on the
    whole batch) of a tiny UNet at `config` (a `UnetConfig`'s keywords) or
    of the ViT at `config` (a `PrimusConfig`: its output volume the single
    tap), from one seeded state."""
    if isinstance(config, PrimusConfig):
        plan, taps = config, (-1,)
    else:
        plan = build_plan(UnetConfig(**config))
        taps = (plan.encoder_idx[-1], plan.num_layers - 1)
    cd = _compute_dtype(dev)
    kw = dict(tap_layers=taps, num_patches=16, nce_temperature=0.33,
              compute_dtype=cd)
    losses = []
    for m in (mesh, None):
        state = init_train_state(plan, torch.Generator().manual_seed(seed),
                                 tap_layers=taps, netf_nc=32, device=dev)
        step = build_train_step(plan, mesh=m, **kw)
        v, s = ((shard_batch(m, views), shard_batch(m, segs))
                if m is not None else (views, segs))
        _, metrics = step(state, v, s,
                          torch.Generator(device=dev).manual_seed(seed + 1))
        losses.append(float(metrics["loss"]))
    return losses


def run_rank(rank: int, world: int, dev: torch.device) -> dict:
    """Phases 1-5 and 7 on this rank; returns each phase's numbers."""
    cd = _compute_dtype(dev)
    out = {}
    rng = np.random.default_rng(0)
    views = torch.from_numpy(rng.standard_normal(
        (world, 2, 16, 16, 16, 1)).astype(np.float32)).to(dev)
    segs = torch.from_numpy(rng.integers(0, 3, (world, 16, 16, 16, 1))
                            ).to(dev)

    # 1. data-parallel step of the 6M topology
    mesh = data_mesh(world, device=dev)
    out["loss"], out["loss_one"] = dp_step_losses(TINY, mesh, dev, views,
                                                  segs, seed=0)

    # 2. spatially sharded forward on a (data, space) mesh
    space = 2 if world % 2 == 0 else 1
    mesh2 = space_mesh(world // space, space, device=dev)
    plan = build_plan(UnetConfig(**TINY))
    sd = init_params(plan, torch.Generator().manual_seed(2))
    stride = 2 ** plan.config.num_downs
    D = max(16, space * stride * 4)
    vol = torch.from_numpy(rng.standard_normal((1, D, 16, 16, 1)).astype(
        np.float32)).to(dev)
    fx = dict(compute_dtype=cd, device=dev)
    ref = make_feature_extractor(plan, sd, strategy="full", **fx)(vol)
    got = make_feature_extractor(plan, sd, strategy="full", mesh=mesh2,
                                 **fx)(vol)
    out["spatial_err"] = _feature_err(got, ref, cd)

    # 3. window-sharded sliding of the same UNet
    sw = dict(strategy="sliding", roi_size=(8, 8, 8), sw_batch_size=2,
              overlap=0.5, **fx)
    ref = make_feature_extractor(plan, sd, **sw)(vol)
    got = make_feature_extractor(plan, sd, mesh=mesh2, **sw)(vol)
    out["window_err"] = float((got - ref).abs().max()
                              / ref.abs().max().clamp_min(1e-30))

    # 4. the ViT's windows through the sharded stitch
    model = Primus.from_state_dict(
        TINY_VIT, init_primus_params(TINY_VIT,
                                     torch.Generator().manual_seed(3)),
        device=dev)
    vvol = torch.from_numpy(rng.standard_normal((1, 24, 16, 16, 1)).astype(
        np.float32)).to(dev)

    def vit_fn(w):
        return model(w, compute_dtype=cd)

    vkw = dict(roi_size=TINY_VIT.input_shape, sw_batch_size=2, overlap=0.5)
    with torch.inference_mode():
        ref = sliding_window_inference(vvol, vit_fn, 4, **vkw)
        got = sliding_window_inference(vvol, vit_fn, 4, mesh=mesh2,
                                       mesh_axis="data", **vkw)
    out["vit_window_err"] = float((got - ref).abs().max()
                                  / ref.abs().max().clamp_min(1e-30))

    # 5. data-parallel step of the dev topology
    out["dev_loss"], out["dev_loss_one"] = dp_step_losses(
        TINY_DEV, mesh, dev, views, segs, seed=4)

    # 7. data-parallel step of the ViT, v2 and v1 tokenizers
    for key, cfg in (("vit_loss", TINY_VIT), ("vit1_loss", TINY_VIT1)):
        out[key], out[f"{key}_one"] = dp_step_losses(cfg, mesh, dev, views,
                                                      segs, seed=6)
    return out


def trainer_losses(n: int, device: str) -> dict:
    """Phase 6: the logged step losses and val losses of the trainer over
    n spawned ranks (`dp`) and on one device (`one`), from the same seeds
    and seeded subjects."""
    rng = np.random.default_rng(5)

    def subjects(k):
        return {f"{i:06d}": {
            "img": rng.random((2, 16, 16, 16), np.float32),
            "seg": rng.integers(0, 3, (16, 16, 16)).astype(np.uint8)}
            for i in range(k)}

    train_data, val_data = subjects(2 * n), subjects(2)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, world in (("one", 1), ("dp", n)):
            cfg = PretrainConfig(
                name=name, ckpt_dir=tmp, dataroot=tmp, ndims=3, input_nc=1,
                output_nc=4, ngf=4, num_downs=2, nce_layers=(11, 33),
                netF_nc=16, n_mlps=2, num_patches=16, crop_size=16,
                batch_size=n, n_epochs=1, n_epochs_decay=0, print_freq=1,
                display_freq=0, save_latest_freq=2, evaluation_freq=2,
                n_val_during_train=1, max_iters=2, lr_policy="plateau",
                data_parallel_devices=world)
            train(cfg, train_data, val_data, device=device)
            with open(os.path.join(tmp, name, "scalars.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            out[name] = [r["loss/loss"] for r in recs if "loss/loss" in r]
            out[f"{name}_val"] = [r["loss/val"] for r in recs
                                  if "loss/val" in r]
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def check(res: dict, cd: torch.dtype) -> list[str]:
    """The phases of one rank's results that miss their tolerance."""
    bad = []
    for k in ("loss", "dev_loss", "vit_loss", "vit1_loss"):
        one = res[f"{k}_one"]
        if not (np.isfinite(res[k])
                and abs(res[k] - one) <= TOL_LOSS[cd] * abs(one)):
            bad.append(f"{k} {res[k]!r} vs one rank {one!r}")
    if not res["spatial_err"] < TOL_FEATS[cd]:
        bad.append(f"spatial_err {res['spatial_err']}")
    for k in ("window_err", "vit_window_err"):
        if not res[k] < TOL_STITCH:
            bad.append(f"{k} {res[k]}")
    return bad


def dryrun(n: int, device: str = "cuda", with_train: bool = False) -> dict:
    """Run phases 1-5 and 7 on n ranks, and the trainer's with
    `with_train`; returns rank 0's numbers (and the trainer's under
    'train'), raises if any rank or the trainer misses a tolerance."""
    results = spawn(run_rank, n, device)
    cd = _compute_dtype(torch.device(device))
    for rank, res in enumerate(results):
        bad = check(res, cd)
        if bad:
            raise RuntimeError(f"dryrun_multichip({n}) rank {rank}: {bad}")
    r = results[0]
    print(f"dryrun_multichip({n}) ok: loss={r['loss']:.4f} "
          f"spatial_err={r['spatial_err']:.2e} "
          f"window_err={r['window_err']:.2e} "
          f"vit_window_err={r['vit_window_err']:.2e} "
          f"dev_loss={r['dev_loss']:.4f} "
          f"loss_rel={_rel(r['loss'], r['loss_one']):.2e} "
          f"dev_loss_rel={_rel(r['dev_loss'], r['dev_loss_one']):.2e} "
          f"vit_loss={r['vit_loss']:.4f} "
          f"vit_loss_rel={_rel(r['vit_loss'], r['vit_loss_one']):.2e} "
          f"vit1_loss={r['vit1_loss']:.4f} "
          f"vit1_loss_rel={_rel(r['vit1_loss'], r['vit1_loss_one']):.2e}",
          flush=True)
    if with_train:
        t = r["train"] = trainer_losses(n, device)
        pairs = list(zip(t["dp"] + t["dp_val"], t["one"] + t["one_val"]))
        if ([len(t[k]) for k in ("dp", "one", "dp_val", "one_val")]
                != [2, 2, 1, 1]
                or not all(_rel(a, b) <= TOL_TRAIN[cd] for a, b in pairs)):
            raise RuntimeError(f"dryrun_multichip({n}) trainer: {t}")
        print(f"dryrun_multichip({n}) trainer ok: "
              f"train_loss_rel={max(_rel(a, b) for a, b in pairs):.2e} "
              f"{t}", flush=True)
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, required=True, help="ranks")
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank, NCCL) or cpu (gloo)")
    p.add_argument("--train", action="store_true",
                   help="also run the trainer over N ranks against one")
    args = p.parse_args(argv)
    dryrun(args.n, args.device, with_train=args.train)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
