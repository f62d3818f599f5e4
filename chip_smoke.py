#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`anatomix_tpu_torch`) on one
NVIDIA GPU (written for an H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. the device, its name and power limit (nvidia-smi), then the build of
     every CUDA kernel from `anatomix_tpu_torch/kernels/csrc/` with nvcc;
  2. each kernel against its plain PyTorch version (f32, TF32 off) on the
     same bf16 inputs, at the shapes the 6M UNet, the 94M dev UNet and the
     26M ViT paths give it, with times; the attention forward and dq also
     at ragged N around their tiles, each against its second launch;
  3. `full`: the 6M `anatomix` UNet at full width with seeded weights on a
     256^3 volume through `make_feature_extractor(strategy="full")`, held
     against the port's plain f32 path on the card;
  4. `sliding` at the reference settings (roi 128, overlap 0.8, gaussian,
     sigma-scale 0.25, sw_batch 2) on 256^3 (343 windows), and held against
     the plain f32 path on a 160^3 volume (27 windows);
  5. the 94M `anatomix-dev` UNet (instance norm, Avg pool, trilinear) at
     full width and depth with seeded weights: one 128^3 forward
     (`[dev-fwd128]`), `full_tiled` on 256^3 with 2x2x2 norm tiles
     (`[dev-full_tiled]`, held against the f32 plain path at 256^3) and
     `sliding` at the reference settings on 256^3 (`[dev-sliding]`, held
     against the f32 plain path at 160^3), then the mean voxelwise cosine
     between the dev `full_tiled` and `sliding` features;
  6. the 26M `anatomix-dev-vit` ViT (Primus v2: embed 396, 12 EVA blocks,
     6 heads of 66, 8 registers) at full width and depth with seeded
     weights: one 128^3 window at B=1 through the extractor
     (`[vit-fwd128]`, the fold route, held against the f32 plain path on a
     noisy and a smooth volume) and the Gaussian-blended sliding windows
     at the reference settings on 256^3 (`[vit-sliding]`, 343 windows, the
     fold exit into the stitch, beside the block-space route's time and
     the two routes' mean cosine; held against the f32 plain path at
     160^3); then the v1 ViT (the patch-embed tokenizer) at the same
     widths, patch 8 through the extractor (`[vit1-fwd128]`) and patch 16
     through the model's spatial emit (`[vit1p16-fwd128]`, four decoder
     stages, the interleave exit), each held on both volumes; then
     `[p1-bisect]`: the ViT step's model on the smooth and the noisy step
     batch, each stage's error (tokenizer, blocks, decoder GEMMs, exit)
     against the f32 plain path, and each part alone;
  7. the 6M pretraining step (`[train-step128]`) at the reference
     launcher's full configuration (`PretrainConfig()`: crop 128^3, the two
     views as batch 2, six taps, 512 patches, netF 256x3, AdamW) with
     seeded weights on a seeded synthetic batch: five steps through
     `build_all` -> `step`; the first loss held against the plain f32 path
     (`F.conv3d` under autograd), every conv's dW from the kernels against
     the plain conv backward from the same forward, every dgrad launch
     against its plain version (whole, and on the reflect shell alone),
     and the end-to-end dW beside the floor a bf16 rounding of the views
     sets, on three batches;
  7b. the 94M dev UNet's pretraining step (`[dev-train-step128]`:
     `PretrainConfig` at the `anatomix-dev` options, ngf 32, num_downs 5,
     instance norm eps 1e-2, Avg pool, trilinear, taps 34, 38, 45, 52,
     59, 79; crop 128^3, the two views as batch 2, 512 patches, netF
     256x3, AdamW) with seeded weights on `[train-step128]`'s batch: five
     steps through `build_all` -> `step` on the general train walk (K1 on
     the three-term split, T-x with the shell pass, T-w);
     `dev_pretrain_step_seconds_128crop`, the peak memory; the first loss,
     every conv's dW and every backward launch against the plain
     versions, as in phase 7; the output volume on a smooth and a noisy
     batch to the two-part rule;
  8. the 26M ViT's pretraining step (`[vit-train-step128]`,
     `PretrainConfig(netG="primus")`: the ViT at full width and depth,
     crop 128^3, the two views as batch 2, its single tap, 512 patches,
     netF 256x3, AdamW) with seeded weights on the same synthetic batch:
     five steps through `build_all` -> `step`; the first loss held against
     the plain f32 path, every attention backward launch (dkv, dq) against
     its plain version on the step's own tensors, and each attention's
     (dq, dk, dv) through the whole backward against the plain attention
     backward from the same forward; the output volume against the plain
     f32 path on the smooth and the noisy batch;
  9. the trainer loop, input pipeline included: `[train-loop]`, the port's
     `pretraining.train.train` at `PretrainConfig()` over seeded 160^3
     subjects given as a mapping (three to train on, one to validate; each
     step's batch read, normalized, sent as f16 / i16 and augmented on the
     device by the prefetch thread on its own stream), 8 steps with the
     save and eval cadences at 4, then a resume to 12: per step the loss,
     the host-clock wait for the batch and step, and the step's CUDA-event
     time, every step's launches equal to `[train-step128]`'s, the files of
     the run dir; `[train-loop-gate]`, four batches of the loop's pipeline
     stepped from one state on the kernels and on the f32 plain route, each
     loss within 2.5x the plain route's spread under bf16-rounded views +
     1e-3; `[vit-train-loop]`, the loop with `netG="primus"`, 4 steps;
 10. registration (ConvexAdam on the 6M UNet's features, seeded weights
     written to a `.pth` and loaded by `load_model(ckpt_path=...)`):
     `[registration]` at `bench.py`'s settings (a 192^3 pair of
     `default_rng(3)` uniform volumes x 500, `extract_strategy="full"`,
     grid_sp 2, disp_hw 1, 80 Adam iterations, inverse consistency):
     `registration_solver_seconds_192`, the median of three
     `register_pair` calls after a warm one, beside the extraction's time;
     `[registration-gate]`, a structured 192^3 pair (labelled ellipsoids,
     the moving one warped by a known smooth field of at most 3 voxels)
     registered with the CLI's `sliding` default on the kernels and on the
     f32 plain route: the kernels' macro-Dice must gain 0.1 over the
     unregistered pair and stay within 0.02 of the plain route's;
     `[registration-cli]`, the CLI on NIfTI files of that pair with masks
     (the EDT infill) and `--warp_seg`;
 11. few-shot segmentation finetuning at the CLI's defaults (the 6M UNet
     from a seeded `.pth` and a fresh 1x1x1 head, 4 classes, crop 128^3,
     batch 3, Adam 2e-4, DiceCE) on three seeded 192^3 subjects and a
     256^3 validation subject written as NIfTI (labelled ellipsoids on a
     textured background): `[segmentation]`, 40 steps on the kernels,
     `segmentation_step_seconds_128crop` (median of steps 2+, host clock)
     beside its CUDA-event time, the wait for the batch, the launches of
     each step (those of `[train-step128]`) and the peak memory, and
     `segmentation_val_seconds_256` (125 windows in 32 chunks, K4 at 5
     channels); `[segmentation-gate]`, the same batches on the f32 plain
     route: the first loss, the first four losses against the plain
     route's bf16 spread, every T-x / T-w launch of a step and its dW
     against the plain backward of the same forward, the validation logits
     after training against the plain route on the same parameters (the
     two-part rule, Dice within 0.02), and learning on both routes;
     `[segmentation-cli]`, the CLI for 2 epochs of 4 steps with validation
     and checkpoints; then the 94M dev backbone (`[dev-segmentation]`,
     loaded through `hf_variant="anatomix-dev"` from a seeded local
     `.pth`: eps 1e-2): `dev_segmentation_val_seconds_256` (K1, D1, D2,
     D3, K4), 10 steps at the CLI's defaults on the general train walk,
     `dev_segmentation_step_seconds_128crop`, the first four losses
     against the f32 plain route's bf16-image spread, the validation
     logits at 160^3 to the two-part rule; `[dev-segmentation-cli]`, the
     CLI with `--hf_variant anatomix-dev` for one epoch of 4 steps;
 12. the parallel paths on a process group of this process alone (NCCL,
     a world of one): `[parallel-full]`, the 6M UNet's 256^3 `full`
     through the 'space' route (`make_feature_extractor(mesh=...)`: a halo
     exchange and K1 in its D-valid mode for every conv), bit for bit
     against `full` and to the two-part rule against the f32 plain path,
     its wall time beside `full`'s in turns; `[parallel-dev-full]`, the dev
     UNet's 128^3 `full` through it (the sharded instance norm, the
     trilinear halo) against its unsharded `full`; `[parallel-step]`, the
     6M and the dev pretraining steps: three unsharded steps from the
     seeded state on `[train-step128]`'s batch, and from the state before
     each one step through `build_train_step(mesh=...)`, each pair's loss
     bit for bit, the first against `[train-step128]` /
     `[dev-train-step128]`'s, the launches equal; then `[parallel]`, the
     dry run (`anatomix_tpu_torch.parallel.dryrun`) on min(4, cards) ranks
     of its own, one card each, on NCCL, with its trainer phase (`train`
     with `device="cuda"` on one card and over the ranks);
 14. (run before 13) every UNet option of the JAX package: each new
     kernel mode against its plain version (K1, K3, D3 under replicate and
     circular padding, K1 on a lifted 2-D volume, the SELU epilogue and
     PReLU's slope, T-x's replicate and circular pad adjoints, T-w under
     each and at the dev width, each pair of launches bit for bit, D1's
     SELU and the residual block's `+ 0.1 x`); `[options-full]`, the 6M
     topology with PReLU 0.37, replicate padding and residual connections
     (batch norms with seeded running statistics, unfolded) through `full`
     on 256^3, and how far the batch norms folded into residual-source
     convs (the JAX package's extractor, ROADMAP F10) would land;
     `[options-dev-fwd128]`, the dev topology with SELU, circular padding
     and residuals at 128^3; `[options-2d]`, the 6M widths as a 2-D UNet
     on four 512^2 slices; each on a noisy and a smooth input to the
     two-part rule; `[options-step]`, `build_all(PretrainConfig(actG=
     "prelu"))` for five steps and `[options-step-general]` (batch norm,
     residuals, replicate, SELU) for three, each with `[train-step128]`'s
     gates and its first step run twice from one state, bit for bit (P5);
     `[options-dev-repeat]`, the dev step twice from one state, its spread
     printed;
 13. the `kernels` JSON line (launches on each path, errors, times and
     bounds), then the device's JSON line last.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel the path should run that was not launched fails it.
Every model forward (the 6M, dev and ViT windows, the v1 ViT, the ViT
step's output) is held on a noisy and a smooth volume to the JAX package's
bf16 rule (tests/test_tpu_numerics.py:36-64): mean|err|/std against the f32
plain path under 3e-2, and under 2.5x the plain path run in bf16 + 1e-3.

`--quick` runs phases 1 and 2 only; `--bisect` runs phases 1 and 2, the
P1 bisection and the 6M and dev forwards on both volumes; `--profile` runs
phases 1 and 2, then
profiles the 6M, the dev and the ViT sliding paths on 160^3, one 6M and
one ViT pretraining step at 128^3, one step of the 6M trainer loop
(host time by `record_function` range), the registration solver at
192^3 (its busy share, top device operations, and host time by `reg/*`
range) and one segmentation step and one 256^3 validation (the same, by
`seg/*` range) with torch.profiler, and one dev pretraining step, one
dev finetuning step and one dev 256^3 validation;
`--segmentation` runs phase 1 and then phase 11's 6M part alone;
`--options` runs phase 1, then phase 14 alone (`chiprun_out/
chip_options.json`); `--conv-time` runs phase 1, then times T-w alone at
the dev step's 128^3 96 -> 32 and T-w, K1 and T-x at the 6M step's 128^3
16 -> 16 in rounds (it reads only the wrappers, so a copy of this script
also measures an earlier checkout);
`--parallel` runs phase 1, K1's D-valid rows, then phase 12 alone (the
unsharded steps it compares with run there; `chiprun_out/
chip_parallel.json`);
`--dev-train`
runs phase 1, the backward kernels at the dev widths, then phase 7b and
phase 11's dev part alone (with `--profile`: the dev profiles alone);
`--dgrad-split`
runs phase 1, then times the 6M step's 19 reflect input gradients apart
into conv, fold and glue, and the step itself in rounds
(`run_dgrad_split`; it reads only the dgrad wrapper and the step's entry
points, so a copy of this script also measures an earlier checkout).
The JSON report and the profiles go to
`chiprun_out/`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain: max |kernel - plain| / max |plain|. A bf16 output rounds
# to 8 significant bits (half an ulp is 2^-9 of the value); the f32 sums
# differ only in order. The stitch is f32 throughout; its atomics reorder
# at most the few overlapping windows of one chunk.
TOL_CONV_BF16 = 1e-2
TOL_CONV_F32 = 1e-4
TOL_SCATTER = 1e-5


def tol_conv_f32(k: int) -> float:
    """An f32-out conv's tolerance for a reduction of `k` products:
    TOL_CONV_F32, or k * 2^-24 where that is larger (the two f32 sums in
    different orders each round up to k ulps of the sum; the split convs
    of the live-norm UNet reduce up to 27 * 3072 products)."""
    return max(TOL_CONV_F32, k * 2.0 ** -24)

# the conv's weight gradient: f32 out, sums of up to 4.2 M products in
# another order (and f32 atomics across blocks)
TOL_WGRAD = 1e-3
# the pretraining step's first loss against its plain f32 path
TOL_TRAIN_LOSS = 1e-2
# each conv's dW, mean |error| / std, the step's backward on the kernels
# against the plain conv backward from the same forward: the bound the JAX
# package holds its kernel-vs-XLA train gradients to
# (tests/test_conv_block_train.py:117-123)
TOL_TRAIN_DW = 5e-2
# each attention's (dq, dk, dv), the ViT step's whole backward on the
# kernels against the plain attention backward from the same forward: the
# same bound and metric
TOL_TRAIN_DATTN = 5e-2
# the factor-8 reshuffle moves values and subtracts the same f32 numbers
TOL_EXACT = 0.0
# the ViT step's forward output volume against its plain f32 path, as a
# multiple of the inference path's own error on the same batch (the same
# kernels and precision split; the two read 4.080e-2 and 4.092e-2 on the
# smooth step batch, 1.773e-2 and 1.795e-2 on the noisy one, NVIDIA H100
# 80GB HBM3, 700 W)
TOL_TRAIN_VS_INFER = 1.1
# whole model, bf16 kernels vs the plain f32 path: the bound and the metric
# (mean |error| / std of the f32 features) the JAX package holds its bf16
# TPU path to (tests/test_tpu_numerics.py:23-64); the max error relative to
# max |f32| is printed beside it
TOL_MODEL = 3e-2
# and the second part of that rule (tests/test_tpu_numerics.py:58-60): the
# kernel path within 2.5x the plain path run in bf16, plus 1e-3
TOL_VS_BF16_PLAIN = 2.5
TOL_VS_BF16_PLAIN_ABS = 1e-3
# the dev paths' volume sizes (sliding: 343 windows at 256^3)
DEV_SLIDING_SIZE = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(text: str) -> list[str]:
    """nvcc's `-Xptxas=-v` output as one line per kernel: its name and
    template arguments, registers, barriers, stack, spill stores and loads
    (dynamic shared memory is sized at launch), and the count of each
    remark ptxas made about its wgmma (C75xx); then every error."""
    import re

    def short(mangled):
        # the length-prefixed name that ends in "kernel", then its
        # template arguments. A length may follow other digits or letters
        # of an anonymous namespace's hash ("...14c11conv_kernel"), so
        # every suffix of every digit run is tried and the shortest name
        # that fits is taken.
        found = []
        for m in re.finditer(r"\d+", mangled):
            for k in range(len(m.group())):
                name = mangled[m.end():m.end() + int(m.group()[k:])]
                if re.fullmatch(r"[A-Za-z_]\w*kernel", name):
                    found.append((len(name), m.end()))
        if not found:
            return mangled
        n, at = min(found)
        t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[at + n:])
        args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
        return mangled[at:at + n] + (f"<{', '.join(args)}>" if args else "")

    remarks, rows, errors, name, props = {}, [], [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        r = re.search(r"\((C75\d\d)\).*function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif r:
            per = remarks.setdefault(short(r.group(2)), {})
            per[r.group(1)] = per.get(r.group(1), 0) + 1
        elif "bytes stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append((name, line.split("Used", 1)[1].strip(), props))
            name, props = None, ""
        elif "error" in line:
            errors.append(line.strip())
    out = []
    for name, used, props in rows:
        notes = ", ".join(f"{c} x{n}"
                          for c, n in sorted(remarks.get(name, {}).items()))
        out.append(f"{name}: used {used}; {props}"
                   + (f"; wgmma remarks {notes}" if notes else ""))
    return out + errors


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, min_ms: float = 30.0, max_reps: int = 200) -> float:
    """Mean device time of `fn()` from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max_reps, max(3, min_ms / once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def rel_err(got, ref) -> tuple[float, float]:
    got = got.float()
    ref = ref.float()
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def model_err(got, ref) -> dict:
    """The JAX package's bf16-vs-f32 model metric, with the max error."""
    got = got.float()
    ref = ref.float()
    err, rel = rel_err(got, ref)
    mean_rel = ((got - ref).abs().mean() / (ref.std() + 1e-8)).item()
    return dict(mean_err_over_std=mean_rel, max_abs_err=err,
                max_err_over_max=rel)


# -----------------------------------------------------------------------------
# phase 2: kernels against their plain versions

def check_conv(kc, torch, F, dev, gen, B, S, ci, co, out_f32=False,
               pad="reflect"):
    """conv3x3x3_ndhwc at (B, S^3, ci) -> co, reflect (the ViT tokenizer:
    zeros), relu (exit: none, f32), against its plain version and
    F.conv3d."""
    x = torch.randn((B, S, S, S, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    act = "none" if out_f32 else "relu"
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    kw = dict(act=act, pad_type=pad, out_dtype=out_dtype)
    got = kc.conv3x3x3_ndhwc(x, w, b, **kw)
    ref = kc.conv3x3x3_ndhwc_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    tol = tol_conv_f32(27 * ci) if out_f32 else TOL_CONV_BF16
    ms = cuda_ms(lambda: kc.conv3x3x3_ndhwc(x, w, b, **kw))
    plain_ms = cuda_ms(lambda: kc.conv3x3x3_ndhwc_plain(x, w, b, **kw))
    # yardstick: one library call for the same conv (cuDNN, bf16,
    # channels-last); reflect padding needs the padded input made first
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (1,) * 6,
               mode="reflect" if pad == "reflect" else "constant")
    xc = xc.contiguous(memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * S ** 3
    flops = 2.0 * vox * 27 * ci * co
    nbytes = vox * ci * 2 + 27 * ci * co * 2 + co * 4 + vox * co * (
        4 if out_f32 else 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        shape=f"B{B} {S}^3 {ci}->{co}" + (" f32-out" if out_f32 else "")
        + ("" if pad == "reflect" else " zeros"),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, (S, S, S), ci, co)),
    )


def check_conv_dvalid(kc, torch, F, dev, gen, B, S, ci, co, out_f32=False):
    """conv3x3x3_dvalid_ndhwc, K1's D-valid mode: x (B, S + 2, S, S, ci)
    with its two D-halo planes -> (B, S^3, co), reflect along H and W
    (relu, bf16 out; or the dev split conv's f32 store with no act),
    against its plain version, and F.conv3d on the fully pre-padded
    input."""
    x = torch.randn((B, S + 2, S, S, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="none" if out_f32 else "relu", pad_type="reflect",
              out_dtype=torch.float32 if out_f32 else torch.bfloat16)
    got = kc.conv3x3x3_dvalid_ndhwc(x, w, b, **kw)
    ref = kc.conv3x3x3_dvalid_ndhwc_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    tol = tol_conv_f32(27 * ci) if out_f32 else TOL_CONV_BF16
    ms = cuda_ms(lambda: kc.conv3x3x3_dvalid_ndhwc(x, w, b, **kw))
    plain_ms = cuda_ms(lambda: kc.conv3x3x3_dvalid_ndhwc_plain(x, w, b, **kw))
    # yardstick: one cuDNN call (bf16, channels-last) on the input already
    # padded along H and W; the pad is not timed
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 0, 0),
               mode="reflect").contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * S ** 3
    flops = 2.0 * vox * 27 * ci * co
    nbytes = (B * (S + 2) * S * S * ci * 2 + 27 * ci * co * 2 + co * 4
              + vox * co * (4 if out_f32 else 2))
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        shape=f"B{B} {S + 2}x{S}^2 -> {S}^3 {ci}->{co}"
        + (" f32-out" if out_f32 else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, (S, S, S), ci, co)),
    )


def dvalid_checks(kc, torch, F, dev, gen) -> list:
    """K1's D-valid rows at the sharded paths' shapes: the 6M `full`'s
    16-channel 256^3 conv (B1), the dev UNet's full-resolution split conv
    (B2 128^3, 3 x 32 -> 32, f32 store)."""
    return [check_conv_dvalid(kc, torch, F, dev, gen, 1, 256, 16, 16),
            check_conv_dvalid(kc, torch, F, dev, gen, 2, 128, 96, 32, True)]


def check_determinism(kc, torch, dev, gen):
    """Two launches of the split-K forward conv at the dev bottleneck (B2
    4^3 3072 -> 1024, f32 out): the largest difference between them."""
    ci, co = 3 * 1024, 1024
    x = torch.randn((2, 4, 4, 4, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="none", out_dtype=torch.float32)
    first = kc.conv3x3x3_ndhwc(x, w, b, **kw)
    second = kc.conv3x3x3_ndhwc(x, w, b, **kw)
    torch.cuda.synchronize()
    return dict(max_abs_diff=(first - second).abs().max().item(),
                splits=kc.conv_plan(2, (4, 4, 4), ci, co).splits)


def check_upcat(kc, torch, F, dev, gen, B, S, c1, c2, co):
    """conv3x3x3_upcat_ndhwc: enc (B, S^3, c1) + small (B, (S/2)^3, c2)."""
    enc = torch.randn((B, S, S, S, c1), generator=gen, device=dev).to(
        torch.bfloat16)
    s = S // 2
    small = torch.randn((B, s, s, s, c2), generator=gen, device=dev).to(
        torch.bfloat16)
    ci = c1 + c2
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="relu", pad_type="reflect")
    got = kc.conv3x3x3_upcat_ndhwc(enc, small, w, b, **kw)
    ref = kc.conv3x3x3_upcat_ndhwc_plain(enc, small, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(lambda: kc.conv3x3x3_upcat_ndhwc(enc, small, w, b, **kw))
    plain_ms = cuda_ms(
        lambda: kc.conv3x3x3_upcat_ndhwc_plain(enc, small, w, b, **kw))
    # yardstick: F.conv3d (cuDNN, bf16, channels-last) over the already
    # materialized, reflect-padded concat -- the one library call that does
    # this kernel's arithmetic; the upsample and concat are not timed
    up = small
    for ax in (1, 2, 3):
        up = torch.repeat_interleave(up, 2, dim=ax)
    cat = torch.cat([enc, up], dim=-1).permute(0, 4, 1, 2, 3)
    xc = F.pad(cat, (1,) * 6, mode="reflect").contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * S ** 3
    flops = 2.0 * vox * 27 * ci * co
    nbytes = (vox * c1 * 2 + B * s ** 3 * c2 * 2 + 27 * ci * co * 2 + co * 4
              + vox * co * 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        shape=f"B{B} {S}^3 [{c1}+up({c2})]->{co}", max_abs_err=err,
        rel_err=rel, tol=TOL_CONV_BF16, ok=rel < TOL_CONV_BF16, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, (S, S, S), ci, co)),
    )


def check_scatter(ks, sw, torch, dev, gen, C=16, win_dtype=None,
                  mode="gaussian"):
    """One stitch chunk on the 256^3 x C sliding canvas: two overlapping
    128^3 windows (starts 25 apart, MONAI's stride at overlap 0.8) and one
    masked padding window; f32 windows, or bf16 (the ViT's fold exit);
    Gaussian blend factors, or with `mode="constant"` ones (segmentation's
    validation, whose logits have an odd channel count)."""
    import numpy as np

    r, S = 128, 256
    if mode == "gaussian":
        axes, minv = sw.gaussian_importance_axes((r, r, r), 0.25)
    else:
        axes, minv = [np.ones(r)] * 3, 0.0
    gd, gh, gw = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in axes)
    starts_np = np.array([[0, 25, 50], [25, 50, 25], [0, 0, 0]], np.int32)
    mask_np = np.array([1, 1, 0], np.int32)
    starts = torch.from_numpy(starts_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    out = torch.randn((3, r, r, r, C), generator=gen, device=dev).to(
        win_dtype or torch.float32)
    canvas0 = torch.randn((S, S, S, C), generator=gen, device=dev)
    got = ks.blend_scatter(canvas0.clone(), out, starts, mask, gd, gh, gw,
                           minv)
    ref = ks.blend_scatter_plain(canvas0.clone(), out, starts, mask, gd, gh,
                                 gw, minv)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    canvas = canvas0.clone()
    ms = cuda_ms(lambda: ks.blend_scatter(canvas, out, starts, mask, gd, gh,
                                          gw, minv))
    plain_ms = cuda_ms(lambda: ks.blend_scatter_plain(
        canvas, out, starts, mask, gd, gh, gw, minv))
    # bytes this chunk must move: each real window read once, each canvas
    # voxel they touch read and written once
    touched = torch.zeros((S, S, S), dtype=torch.bool, device=dev)
    for s, m in zip(starts_np.tolist(), mask_np.tolist()):
        if m:
            touched[s[0]:s[0] + r, s[1]:s[1] + r, s[2]:s[2] + r] = True
    n_touch = int(touched.sum().item())
    n_real = int(mask_np.sum())
    elems = n_real * r ** 3 * C
    nbytes = elems * out.element_size() + n_touch * C * 8
    b_ms, b_by = bound(4.0 * elems, nbytes, PEAK_F32_FLOPS)
    return dict(
        shape=f"canvas {S}^3x{C} f32, 3 windows {r}^3 (1 masked)"
        + (" bf16" if out.dtype == torch.bfloat16 else "")
        + (f" {mode}" if mode != "gaussian" else ""),
        max_abs_err=err, rel_err=rel, tol=TOL_SCATTER, ok=rel < TOL_SCATTER,
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
        bound_by=b_by,
    )


def check_cat(kc, torch, F, dev, gen, B, S, c1, c2, co):
    """conv3x3x3_cat_ndhwc: enc (B, S^3, c1) + up (B, S^3, c2), reflect, no
    epilogue act (a live instance norm follows every dev decoder conv)."""
    enc = torch.randn((B, S, S, S, c1), generator=gen, device=dev).to(
        torch.bfloat16)
    up = torch.randn((B, S, S, S, c2), generator=gen, device=dev).to(
        torch.bfloat16)
    ci = c1 + c2
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="none", pad_type="reflect")
    got = kc.conv3x3x3_cat_ndhwc(enc, up, w, b, **kw)
    ref = kc.conv3x3x3_cat_ndhwc_plain(enc, up, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(lambda: kc.conv3x3x3_cat_ndhwc(enc, up, w, b, **kw))
    plain_ms = cuda_ms(
        lambda: kc.conv3x3x3_cat_ndhwc_plain(enc, up, w, b, **kw))
    # yardstick: F.conv3d (cuDNN, bf16, channels-last) over the already
    # materialized, reflect-padded concat; the concat is not timed
    cat = torch.cat([enc, up], dim=-1).permute(0, 4, 1, 2, 3)
    xc = F.pad(cat, (1,) * 6, mode="reflect").contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * S ** 3
    flops = 2.0 * vox * 27 * ci * co
    nbytes = vox * ci * 2 + 27 * ci * co * 2 + co * 4 + vox * co * 2
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        shape=f"B{B} {S}^3 [{c1}+{c2}]->{co}", max_abs_err=err,
        rel_err=rel, tol=TOL_CONV_BF16, ok=rel < TOL_CONV_BF16, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, (S, S, S), ci, co)),
    )


def check_upsample(kr, torch, F, dev, gen, B, s, C, split=False):
    """upsample2x_trilinear_ndhwc: (B, s^3, C) -> (B, (2s)^3, C); with
    `split`, in and out the three-term split (..., 3 C) of f32 volumes (the
    live-norm UNet's decoder), held as f32 values (hi + lo)."""
    from anatomix_tpu_torch.ops.conv import merge3, split3

    x = torch.randn((B, s, s, s, C), generator=gen, device=dev)
    x = split3(x) if split else x.to(torch.bfloat16)
    got = kr.upsample2x_trilinear_ndhwc(x, split=split)
    ref = kr.upsample2x_trilinear_ndhwc_plain(x, split=split)
    torch.cuda.synchronize()
    err, rel = (rel_err(merge3(got), merge3(ref)) if split
                else rel_err(got, ref))
    tol = TOL_CONV_F32 if split else TOL_CONV_BF16
    ms = cuda_ms(lambda: kr.upsample2x_trilinear_ndhwc(x, split=split))
    plain_ms = cuda_ms(lambda: kr.upsample2x_trilinear_ndhwc_plain(
        x, split=split))
    # yardstick: one F.interpolate call on the same bf16 storage (the
    # NCDHW view of an NDHWC tensor is channels-last)
    xc = x.permute(0, 4, 1, 2, 3)
    lib_ms = cuda_ms(lambda: F.interpolate(
        xc, scale_factor=2, mode="trilinear", align_corners=False))
    n_in = B * s ** 3 * C
    # each input read once (hi and lo when split), each output written once
    # (bf16, three terms when split); 8 weighted corners per output element
    b_ms, b_by = bound(16.0 * 8 * n_in,
                       (4.0 + 48.0 if split else 2.0 + 16.0) * n_in,
                       PEAK_F32_FLOPS)
    return dict(
        shape=f"B{B} {s}^3x{C} -> {2 * s}^3" + (" split" if split else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
    )


def check_norm_apply(kn, norms, torch, dev, gen, B, S, C, tiles, act,
                     residual=False, split=True):
    """norm_apply_ndhwc with the statistics of the input itself (eps 1e-2,
    the dev norm), per `tiles`. The input is f32, as the dev path stores the
    convs that feed a live norm; the output bf16, on the card's paths the
    three-term split (..., 3 C), held as f32 values (hi + lo). `residual`:
    the ViT tokenizer's residual operand (split too), lrelu slope 0.01."""
    from anatomix_tpu_torch.ops.conv import merge3, split3

    x = torch.randn((B, S, S, S, C), generator=gen, device=dev)
    mean, var = norms.instance_norm_stats(x, tiles)
    a, s = norms.fold_affine(mean, var, 1e-2)
    maps = norms.tile_maps(x.shape[1:4], tiles, dev)
    kw = dict(act=act, slope=0.01 if residual else 0.3, split=split)
    if residual:
        r = torch.randn(x.shape, generator=gen, device=dev)
        kw["residual"] = split3(r) if split else r.to(torch.bfloat16)
    got = kn.norm_apply_ndhwc(x, a, s, maps, **kw)
    ref = kn.norm_apply_ndhwc_plain(x, a, s, maps, **kw)
    torch.cuda.synchronize()
    err, rel = (rel_err(merge3(got), merge3(ref)) if split
                else rel_err(got, ref))
    tol = TOL_CONV_F32 if split else TOL_CONV_BF16
    ms = cuda_ms(lambda: kn.norm_apply_ndhwc(x, a, s, maps, **kw))
    plain_ms = cuda_ms(lambda: kn.norm_apply_ndhwc_plain(x, a, s, maps, **kw))
    n = x.numel()
    # f32 in, bf16 out (three terms when split) and the residual (its hi and
    # lo when split), the (a, s) rows and the maps once
    per = 4.0 + (6.0 if split else 2.0) + (
        (4.0 if split else 2.0) if residual else 0.0)
    nbytes = per * n + 8.0 * a.numel() + 4.0 * sum(m.numel() for m in maps)
    b_ms, b_by = bound((4.0 if residual else 3.0) * n, nbytes,
                       PEAK_F32_FLOPS)
    return dict(
        shape=f"B{B} {S}^3x{C} tiles {tiles} {act}"
        + (" +residual" if residual else "") + (" split" if split else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )


def check_conv_down(kc, kd, torch, F, dev, gen, B, S, ci, co):
    """conv_down2_ndhwc: (B, S^3, ci) -> (B, (S/2)^3, co), zero padding 1,
    f32 store (an instance norm follows every tokenizer conv), with the
    launch plan `conv_plan(..., mode=MODE_S2)` picks."""
    x = torch.randn((B, S, S, S, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="none", out_dtype=torch.float32)
    got = kd.conv_down2_ndhwc(x, w, b, **kw)
    ref = kd.conv_down2_ndhwc_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(lambda: kd.conv_down2_ndhwc(x, w, b, **kw))
    plain_ms = cuda_ms(lambda: kd.conv_down2_ndhwc_plain(x, w, b, **kw))
    # yardstick: one stride-2 F.conv3d (cuDNN, bf16, channels-last)
    xc = x.permute(0, 4, 1, 2, 3)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    bb = b.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, bb, stride=2, padding=1))
    s = S // 2
    flops = 2.0 * B * s ** 3 * 27 * ci * co
    nbytes = (B * S ** 3 * ci * 2 + 27 * ci * co * 2 + co * 4
              + B * s ** 3 * co * 4)
    b_ms, b_by = bound(flops, nbytes)
    plan = kc.conv_plan(B, (s, s, s), ci, co, mode=kc.MODE_S2)
    ring = (down2_brick_vs_ring(kc, kd, torch, x, w, b, kw, ref)
            if plan.brick else None)
    return dict(
        shape=f"B{B} {S}^3x{ci} -> {s}^3x{co} f32-out", max_abs_err=err,
        rel_err=rel, tol=tol_conv_f32(27 * ci),
        ok=rel < tol_conv_f32(27 * ci), ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(plan, kc.MODE_S2), brick_vs_ring=ring,
    )


def down2_brick_vs_ring(kc, kd, torch, x, w, b, kw, ref) -> dict:
    """V2 where `conv_plan` picks the parity-split brick, against the
    gather ring it picks once the brick is ruled out (`brick_chunk` made to
    return 0 for those calls): four rounds of ring, brick, brick, ring in
    one process, each a CUDA-event mean, the spread of each plan's rounds,
    and the ring's error against the plain version."""
    brick_chunk = kc.brick_chunk

    def ring():
        kc.brick_chunk = lambda *a, **k: 0
        try:
            return kd.conv_down2_ndhwc(x, w, b, **kw)
        finally:
            kc.brick_chunk = brick_chunk

    def brick():
        return kd.conv_down2_ndhwc(x, w, b, **kw)

    got = ring()
    torch.cuda.synchronize()
    ring_err, _ = rel_err(got, ref)
    times = {"ring": [], "brick": []}
    for _ in range(4):
        for name, fn in (("ring", ring), ("brick", brick), ("brick", brick),
                         ("ring", ring)):
            times[name].append(cuda_ms(fn))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    spread = {k: max(v) - min(v) for k, v in times.items()}
    log(f"[kernel] conv_down2_ndhwc {tuple(x.shape)} -> Co {w.shape[1]} "
        f"brick vs ring (rounds ring, brick, brick, ring): brick "
        f"{times['brick']} ms, ring {times['ring']} ms; means "
        f"{mean['brick']:.4f} / {mean['ring']:.4f} ms (brick / ring "
        f"{mean['brick'] / mean['ring']:.4f}), spreads "
        f"{spread['brick']:.4f} / {spread['ring']:.4f} ms; ring max_abs_err "
        f"{ring_err:.3e}; {nvidia_smi()}")
    return dict(brick_ms=times["brick"], ring_ms=times["ring"],
                ring_max_abs_err=ring_err)


def check_conv_down_determinism(kd, torch, dev, gen):
    """Two launches of V2 at its split-K stage (B2 32^3 x 384 -> 16^3 x
    256, f32 out): the largest difference between them."""
    ci, co = 3 * 128, 256
    x = torch.randn((2, 32, 32, 32, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    first = kd.conv_down2_ndhwc(x, w, b, out_dtype=torch.float32)
    second = kd.conv_down2_ndhwc(x, w, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    return (first - second).abs().max().item()


def sdpa_backend(torch, q, k, v, scale) -> str:
    """The backend torch's scaled_dot_product_attention picks for these
    inputs."""
    try:
        from torch.nn.attention import SDPBackend

        idx = torch._fused_sdp_choice(q, k, v, None, 0.0, False,
                                      scale=scale)
        return SDPBackend(idx).name
    except Exception as e:  # a private helper; its absence is reported
        return f"unknown ({type(e).__name__})"


def check_attention(ka, torch, F, dev, gen, B, H, N, hd):
    """flash_attention at (B, H, N, hd) bf16, scale 1/sqrt(hd), and its
    second launch (bit-equal)."""
    q, k, v = (torch.randn((B, H, N, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    scale = hd ** -0.5
    got = ka.flash_attention(q, k, v, scale)
    ref = ka.flash_attention_plain(q, k, v, scale)
    repeats = bool(torch.equal(got, ka.flash_attention(q, k, v, scale)))
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    del got, ref
    ms = cuda_ms(lambda: ka.flash_attention(q, k, v, scale))
    plain_ms = cuda_ms(lambda: ka.flash_attention_plain(q, k, v, scale))
    # yardstick: torch's fused attention on the same bf16 tensors
    backend = sdpa_backend(torch, q, k, v, scale)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale))
    log(f"[kernel] sdpa backend at {tuple(q.shape)}: {backend}")
    flops = 4.0 * B * H * N * N * hd
    b_ms, b_by = bound(flops, 4.0 * 2 * B * H * N * hd)
    return dict(
        shape=f"B{B} H{H} N{N} hd{hd}", max_abs_err=err, rel_err=rel,
        tol=TOL_CONV_BF16, ok=rel < TOL_CONV_BF16 and repeats, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        sdpa_backend=backend, repeats=repeats,
    )


def check_attention_ragged(ka, torch, dev, gen) -> list[str]:
    """The forward and dq at ragged N around their tiles (64 keys, 192
    queries a block; 128 at hd 128) against their plain versions within
    1e-2 (max|err| / max|ref|), and each against its own second launch
    (bit-equal); the failures. dq at N 1 is zero but for the rounding of
    dO v^T - di (one key), so it is held to the forward's N only."""
    failed = []
    for N in (1, 127, 129, 191, 193):
        for hd in (16, 66, 80, 128):
            q, k, v, do = (torch.randn((1, 2, N, hd), generator=gen,
                                       device=dev).to(torch.bfloat16)
                           for _ in range(4))
            scale = hd ** -0.5
            o, lse = ka.flash_attention(q, k, v, scale, return_lse=True)
            same = bool(torch.equal(o, ka.flash_attention(q, k, v, scale)))
            rel = rel_err(o, ka.flash_attention_plain(q, k, v, scale))[1]
            line = f"fwd rel {rel:.3e} bit-equal {same}"
            ok = same and rel < TOL_CONV_BF16
            if hd <= 80 and N > 1:
                di = ka.attention_di(o, do)
                args = (q, k, v, lse, do, di, scale)
                dq = ka.flash_attention_bwd_dq(*args)
                dq_same = bool(torch.equal(dq, ka.flash_attention_bwd_dq(
                    *args)))
                dq_rel = rel_err(dq, ka.flash_attention_bwd_dq_plain(
                    *args))[1]
                line += f"; dq rel {dq_rel:.3e} bit-equal {dq_same}"
                ok = ok and dq_same and dq_rel < TOL_CONV_BF16
            torch.cuda.synchronize()
            log(f"[kernel] attention ragged B1 H2 N{N} hd{hd}: {line}")
            if not ok:
                failed.append(f"attention ragged N{N} hd{hd}")
    return failed


def check_attention_lse(ka, torch, dev, gen, B, H, N, hd):
    """flash_attention with its log-sum-exp output: the output equal to the
    forward's without it, the lse (f32) within 1e-4 of max |lse|."""
    q, k, v = (torch.randn((B, H, N, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    scale = hd ** -0.5
    o, lse = ka.flash_attention(q, k, v, scale, return_lse=True)
    ref_o, ref_lse = ka.flash_attention_lse_plain(q, k, v, scale)
    torch.cuda.synchronize()
    same = bool(torch.equal(o, ka.flash_attention(q, k, v, scale)))
    err, rel = rel_err(lse, ref_lse)
    ms = cuda_ms(lambda: ka.flash_attention(q, k, v, scale,
                                            return_lse=True))
    plain_ms = cuda_ms(lambda: ka.flash_attention_lse_plain(q, k, v, scale))
    lib_ms, form, lib_lse = sdpa_lse(torch, q, k, v, scale)
    lse_diff = (float((lib_lse[..., :N].float() - lse).abs().max())
                if lib_lse is not None else None)
    log(f"[kernel] lse-returning sdpa at {tuple(q.shape)}: {form}; its lse "
        f"vs the kernel's: max|diff| {lse_diff}")
    flops = 4.0 * B * H * N * N * hd
    b_ms, b_by = bound(flops, 4.0 * 2 * B * H * N * hd + 4.0 * B * H * N)
    return dict(
        shape=f"B{B} H{H} N{N} hd{hd} +lse", max_abs_err=err, rel_err=rel,
        tol=TOL_CONV_F32, ok=same and rel < TOL_CONV_F32, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        out_unchanged=same, library_form=form, library_lse_diff=lse_diff,
    )


def sdpa_lse(torch, q, k, v, scale):
    """(ms, form, lse) of one torch call that returns attention's output and
    its log-sum-exp: aten's flash op (on head dims padded to a multiple of 8
    inside the timed call, as `scaled_dot_product_attention` pads them, if
    it refuses the unpadded ones), else the memory-efficient op with
    `compute_log_sumexp`; (None, reason, None) if neither runs."""
    import torch.nn.functional as F

    aten = torch.ops.aten
    hd = q.shape[-1]
    pad = -hd % 8
    tries = (
        ("aten._scaled_dot_product_flash_attention", lambda: (
            aten._scaled_dot_product_flash_attention(q, k, v, scale=scale))),
        (f"aten._scaled_dot_product_flash_attention, hd padded to "
         f"{hd + pad} in the call", lambda: (
             aten._scaled_dot_product_flash_attention(
                 *(F.pad(t, (0, pad)) for t in (q, k, v)), scale=scale))),
        ("aten._scaled_dot_product_efficient_attention(compute_log_sumexp)",
         lambda: aten._scaled_dot_product_efficient_attention(
             q, k, v, None, True, scale=scale)),
    )
    reasons = []
    for form, call in tries:
        try:
            lse = call()[1]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 (a private op)
            reasons.append(f"{form}: {str(e).splitlines()[0][:120]}")
            continue
        return cuda_ms(call), form, lse
    return None, "none ran (" + "; ".join(reasons) + ")", None


def sdpa_backward_ms(torch, F, q, k, v, do, scale):
    """One backward of torch's scaled_dot_product_attention (dq, dk, dv
    through `torch.autograd.grad`) on the same bf16 tensors, and its
    backend: the yardstick of the dkv and dq kernels together."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    return cuda_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True)), sdpa_backend(
        torch, qs, ks, vs, scale)


def check_attention_bwd(ka, torch, F, dev, gen, B, H, N, hd):
    """flash_attention_bwd_dkv and flash_attention_bwd_dq at (B, H, N, hd)
    bf16 from the kernel forward's lse, against their plain versions on the
    same inputs, dkv also against its own second launch (bit-equal);
    library: SDPA's whole backward, beside the sum of the two kernels."""
    q, k, v, do = (torch.randn((B, H, N, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    scale = hd ** -0.5
    o, lse = ka.flash_attention(q, k, v, scale, return_lse=True)
    di = ka.attention_di(o, do)
    args = (q, k, v, lse, do, di, scale)
    lib_ms, backend = sdpa_backward_ms(torch, F, q, k, v, do, scale)
    log(f"[kernel] sdpa backward backend at {tuple(q.shape)}: {backend}")
    rows = {}
    in_bytes = 4.0 * 2 * B * H * N * hd + 2 * 4.0 * B * H * N
    for name, fn, plain, flops, outs in (
        ("flash_attention_bwd_dkv", ka.flash_attention_bwd_dkv,
         ka.flash_attention_bwd_dkv_plain, 8.0 * B * H * N * N * hd, 2),
        ("flash_attention_bwd_dq", ka.flash_attention_bwd_dq,
         ka.flash_attention_bwd_dq_plain, 6.0 * B * H * N * N * hd, 1),
    ):
        got = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        del got, ref, again
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: plain(*args), max_reps=20)
        b_ms, b_by = bound(flops, in_bytes + outs * 4.0 * B * H * N * hd)
        rows[name] = dict(
            shape=f"B{B} H{H} N{N} hd{hd}", max_abs_err=err, rel_err=rel,
            tol=TOL_CONV_BF16, ok=rel < TOL_CONV_BF16 and repeats, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, sdpa_backend=backend, repeats=repeats,
        )
    pair = rows["flash_attention_bwd_dkv"]["ms"] + rows[
        "flash_attention_bwd_dq"]["ms"]
    log(f"[kernel] attention backward B{B} H{H} N{N} hd{hd}: dkv + dq "
        f"{pair:.4f} ms, SDPA's whole backward {lib_ms:.4f} ms "
        f"({pair / lib_ms:.2f}x); two launches bit-equal: dkv "
        f"{rows['flash_attention_bwd_dkv']['repeats']}, dq "
        f"{rows['flash_attention_bwd_dq']['repeats']}")
    return rows


def check_d2s8(kr8, torch, dev, gen, B, d, C, with_sub):
    """depth_to_space8_ndhwc: (B, d^3, 512 C) bf16 -> (B, (8d)^3, C) f32,
    with or without the demean subtract. Exact: both versions subtract the
    same f32 values."""
    y = torch.randn((B, d, d, d, 512 * C), generator=gen, device=dev).to(
        torch.bfloat16)
    sub = (torch.randn((B, 512 * C), generator=gen, device=dev)
           if with_sub else None)
    got = kr8.depth_to_space8_ndhwc(y, sub)
    ref = kr8.depth_to_space8_ndhwc_plain(y, sub)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(lambda: kr8.depth_to_space8_ndhwc(y, sub))
    plain_ms = cuda_ms(lambda: kr8.depth_to_space8_ndhwc_plain(y, sub))
    # yardstick: the permutation alone as one strided copy (bf16 to bf16:
    # no f32 store, no subtract)
    lib_ms = cuda_ms(lambda: y.view(B, d, d, d, *(2,) * 9, C).permute(
        0, 1, 4, 7, 10, 2, 5, 8, 11, 3, 6, 9, 12, 13).contiguous())
    n = y.numel()
    nbytes = 2.0 * n + 4.0 * n + (4.0 * sub.numel() if with_sub else 0.0)
    b_ms, b_by = bound(float(n) if with_sub else 0.0, nbytes,
                       PEAK_F32_FLOPS)
    return dict(
        shape=f"B{B} {d}^3x{512 * C} -> {8 * d}^3x{C}"
        + (" -sub" if with_sub else ""), max_abs_err=err, rel_err=rel,
        tol=TOL_EXACT, ok=rel <= TOL_EXACT, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
    )


def check_reshuffle2(kr8, torch, dev, gen, B, S, C, which):
    """space_to_depth2_ndhwc (B, S^3, C) -> (B, (S/2)^3, 8 C), or
    depth_to_space2_ndhwc back to (B, S^3, C), bf16, against its plain
    version. Exact: both move the same values."""
    if which == "s2d":
        x = torch.randn((B, S, S, S, C), generator=gen, device=dev).to(
            torch.bfloat16)
        fn = lambda: kr8.space_to_depth2_ndhwc(x)  # noqa: E731
        plain = lambda: kr8.space_to_depth2_ndhwc_plain(x)  # noqa: E731
        h = S // 2
        lib = lambda: x.view(B, h, 2, h, 2, h, 2, C).permute(  # noqa: E731
            0, 1, 3, 5, 2, 4, 6, 7).contiguous()
        shape = f"B{B} {S}^3x{C} -> {S // 2}^3x{8 * C}"
    else:
        h = S // 2
        x = torch.randn((B, h, h, h, 8 * C), generator=gen, device=dev).to(
            torch.bfloat16)
        fn = lambda: kr8.depth_to_space2_ndhwc(x)  # noqa: E731
        plain = lambda: kr8.depth_to_space2_ndhwc_plain(x)  # noqa: E731
        lib = lambda: x.view(B, h, h, h, 2, 2, 2, C).permute(  # noqa: E731
            0, 1, 4, 2, 5, 3, 6, 7).contiguous()
        shape = f"B{B} {h}^3x{8 * C} -> {S}^3x{C}"
    got = fn()
    ref = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    # yardstick: one strided copy (view, permute, contiguous)
    lib_ms = cuda_ms(lib)
    b_ms, b_by = bound(0.0, 2.0 * x.numel() * x.element_size())
    return dict(shape=shape, max_abs_err=err, rel_err=rel, tol=TOL_EXACT,
                ok=rel <= TOL_EXACT, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_d2s_sub(kr8, torch, dev, gen, B, d, C, which, in_dtype,
                  out_dtype):
    """depth_to_space_fold_ndhwc or depth_to_space_interleave_ndhwc:
    (B, d^3, 8 C) -> (B, (2d)^3, C) minus the demean `sub`, against its plain
    version. Exact: both subtract the same f32 values and round once."""
    y = torch.randn((B, d, d, d, 8 * C), generator=gen, device=dev).to(
        in_dtype)
    sub = torch.randn((B, 8 * C), generator=gen, device=dev)
    name = f"depth_to_space_{which}_ndhwc"
    fn = lambda: getattr(kr8, name)(y, sub, out_dtype=out_dtype)  # noqa
    plain = lambda: getattr(kr8, name + "_plain")(  # noqa: E731
        y, sub, out_dtype=out_dtype)
    got, ref = fn(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    # yardstick: one strided copy with the subtract (view, permute, the f32
    # subtract, the cast)
    lib_ms = cuda_ms(lambda: (y.view(B, d, d, d, 2, 2, 2, C).float()
                              - sub.view(B, 1, 1, 1, 2, 2, 2, C)).permute(
        0, 1, 4, 2, 5, 3, 6, 7).to(out_dtype).contiguous())
    n = y.numel()
    nbytes = (n * y.element_size() + n * got.element_size()
              + 4.0 * sub.numel())
    b_ms, b_by = bound(float(n), nbytes, PEAK_F32_FLOPS)
    tag = {torch.bfloat16: "bf16", torch.float32: "f32"}
    return dict(
        shape=f"B{B} {d}^3x{8 * C} {tag[in_dtype]} -> {2 * d}^3x{C} "
        f"{tag[out_dtype]} -sub" + (" (folded rows)" if which == "fold"
                                    else ""),
        max_abs_err=err, rel_err=rel, tol=TOL_EXACT, ok=rel <= TOL_EXACT,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by,
    )


def check_c1(kr8, torch, dev, gen, B, S, dtype):
    """space_to_depth_c1_ndhwc: (B, S^3) -> (B, (S/2)^3, 8), against its
    plain version. Exact: both move the same values."""
    x = torch.randn((B, S, S, S), generator=gen, device=dev).to(dtype)
    fn = lambda: kr8.space_to_depth_c1_ndhwc(x)  # noqa: E731
    plain = lambda: kr8.space_to_depth_c1_ndhwc_plain(x)  # noqa: E731
    got, ref = fn(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    h = S // 2
    lib_ms = cuda_ms(lambda: x.view(B, h, 2, h, 2, h, 2).permute(
        0, 1, 3, 5, 2, 4, 6).contiguous())
    b_ms, b_by = bound(0.0, 2.0 * x.numel() * x.element_size())
    tag = {torch.bfloat16: "bf16", torch.float32: "f32"}
    return dict(shape=f"B{B} {S}^3 {tag[dtype]} -> {h}^3x8", max_abs_err=err,
                rel_err=rel, tol=TOL_EXACT, ok=rel <= TOL_EXACT, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def conv_backward_library(torch, F, x, dy, w, pad, mask, stride2=False):
    """One cuDNN backward call (bf16, channels-last) of the conv on the
    pre-padded input: the weight gradient (mask (False, True, False)) or
    the gradient of the padded input (mask (True, False, False), without
    the pad's adjoint). With `stride2`, the stride-2 pad-1 conv's backward
    on the unpadded input, from its own (S/2)^3 output gradient `dy`."""
    ci, co = x.shape[-1], dy.shape[-1]
    xc = x.permute(0, 4, 1, 2, 3)
    if not stride2:
        xc = F.pad(xc, (1,) * 6,
                   mode="reflect" if pad == "reflect" else "constant")
    xc = xc.contiguous(memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    dyc = dy.permute(0, 4, 1, 2, 3)
    st, pd = ([2] * 3, [1] * 3) if stride2 else ([1] * 3, [0] * 3)
    return lambda: torch.ops.aten.convolution_backward(
        dyc, xc, wt, None, st, pd, [1, 1, 1], False, [0, 0, 0], 1,
        list(mask))


def conv_plan_desc(plan, mode=0) -> str:
    """A conv launch plan of `kernels/conv.py` as the [kernel] lines print
    it: the M tile, the N tile, the split of K, the grid (the stride-2
    input gradient's gather grid runs its 8 parity classes on z) and the
    dynamic shared memory a block takes (as `csrc/conv3d.cu` sizes it).
    `mode` as `conv_plan`'s: 0 stride 1, 1 the stride-2 input gradient, 2
    the stride-2 conv."""
    if plan.brick and mode == 2:
        tile = (f"parity-split halo brick 8x8x4 (17x17x9 halo), K chunk "
                f"{plan.chunk}, 27 taps in 14 K16 steps")
        grid = (plan.m_tiles, plan.n_tiles)
        halo = 17 * 17 * 9
        smem = 2 * (halo * 16 + 14 * 16 * plan.bn * 2) + halo * 4
    elif plan.brick:
        tile = f"halo brick 8x8x4, K chunk {plan.chunk}"
        grid = (plan.m_tiles, plan.n_tiles)
        halo = 9 * 9 * 5 if mode == 1 else 10 * 10 * 6
        smem = halo * plan.chunk * 2 + 27 * plan.chunk * plan.bn * 2
    else:
        tile = (f"tile {1 << plan.bx}x{1 << plan.by}x{1 << plan.bz}"
                f"x{1 << plan.bb}b, ring {plan.stages}")
        grid = (plan.m_tiles, plan.n_tiles,
                8 if mode == 1 else plan.splits)
        smem = plan.stages * (128 * 64 * 2 + 64 * plan.bn * 2)
    blocks = 1
    for g in grid:
        blocks *= g
    return (f"{tile}, N tile {plan.bn}, split {plan.splits}, grid "
            f"{grid} = {blocks} blocks, {smem} B shared memory")


def wgrad_plan_desc(plan, ci) -> str:
    """A weight-gradient launch plan of `kernels/conv_train.py`, with the
    dynamic shared memory a block takes (as `csrc/conv3d_wgrad.cu` sizes
    it: a 4-stage ring)."""
    if plan.halo:
        tile = f"halo brick 8x4x4, all {plan.m_tiles} m64 row tiles"
        grid = (plan.n_tiles, plan.splits)
        smem = 4 * (-(-ci // 8) * 360 * 16 + 128 * plan.bn * 2)
    else:
        tile = (f"brick {1 << plan.bx}x{1 << plan.by}x{1 << plan.bz}"
                f"x{1 << plan.bb}b, 128-row tiles")
        grid = (plan.m_tiles, plan.n_tiles, plan.splits)
        smem = 4 * (128 * 64 * 2 + 64 * plan.bn * 2)
    blocks = 1
    for g in grid:
        blocks *= g
    return (f"{tile}, N tile {plan.bn}, split {plan.splits} x "
            f"{plan.bricks_per_split} bricks, grid {grid} = {blocks} blocks, "
            f"{smem} B shared memory")


def check_conv_backward(kt, torch, F, dev, gen, B, S, ci, co, which,
                        pad="reflect", stride2=False):
    """conv3x3x3_wgrad_ndhwc (dW f32) or conv3x3x3_dgrad_ndhwc (dx bf16)
    at (B, S^3): ci -> co, against its plain version and cuDNN's backward.
    With `stride2`, the stride-2 pad-1 conv's (the ViT tokenizer's down
    convs): dy on its own ((S+1)/2)^3 grid, the kernels' stride-2 mode."""
    x = torch.randn((B, S, S, S, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    s2 = (S - 1) // 2 + 1
    g = s2 if stride2 else S
    dy = torch.randn((B, g, g, g, co), generator=gen, device=dev).to(
        torch.bfloat16)
    work = B * g ** 3
    stride = 2 if stride2 else 1
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    spatial = (S, S, S)
    if which == "wgrad":
        fn = lambda: kt.conv3x3x3_wgrad_ndhwc(  # noqa: E731
            x, dy, pad_type=pad, stride=stride)
        plain = lambda: kt.conv3x3x3_wgrad_ndhwc_plain(  # noqa: E731
            x, dy, pad_type=pad, stride=stride)
        mask, tol = (False, True, False), TOL_WGRAD
        out_bytes = 27 * ci * co * 4
        in_bytes = B * S ** 3 * ci * 2 + work * co * 2
        plan = wgrad_plan_desc(kt.wgrad_plan(B, (g, g, g), ci, co, stride),
                               ci)
    else:
        fn = lambda: kt.conv3x3x3_dgrad_ndhwc(  # noqa: E731
            dy, w, pad_type=pad, stride=stride, spatial=spatial)
        plain = lambda: kt.conv3x3x3_dgrad_ndhwc_plain(  # noqa: E731
            dy, w, pad_type=pad, stride=stride, spatial=spatial)
        mask, tol = (True, False, False), TOL_CONV_BF16
        out_bytes = B * S ** 3 * ci * 2
        in_bytes = work * co * 2 + 27 * ci * co * 2
        grid = ((g, g, g) if stride2 or pad != "reflect"
                else (S + 2, S + 2, S + 2))
        mode = kt.MODE_S2_DGRAD if stride2 else 0
        plan = conv_plan_desc(kt.conv_plan(B, grid, co, ci, mode=mode), mode)
    got = fn()
    ref = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    lib_ms = cuda_ms(conv_backward_library(torch, F, x, dy, w, pad, mask,
                                           stride2))
    b_ms, b_by = bound(2.0 * work * 27 * ci * co, in_bytes + out_bytes)
    row = dict(
        shape=f"B{B} {S}^3 {ci}->{co}" + ("" if pad == "reflect" else
                                          " zeros") + (
            " stride-2 (dy on its own grid)" if stride2 else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=plan,
    )
    if which == "dgrad" and pad == "reflect":
        # the reflect route's two launches apart, the shell's own error and
        # two launches' bits
        dx, g_ext = kt.pad_dgrad_store(dy, w)
        again = fn()
        torch.cuda.synchronize()
        row.update(
            shell_rel_err=shell_rel_err(torch, got, ref),
            repeat_max_abs_diff=(got.float() - again.float()).abs().max()
            .item(),
            conv_ms=cuda_ms(lambda: kt.pad_dgrad_store(dy, w)),
            fold_ms=cuda_ms(lambda: kt.pad_shell_ndhwc(g_ext, dx)),
            fold_library_ms=cuda_ms(fold_library(
                torch, torch.randn_like(g_ext))))
        row["ok"] = (row["ok"] and row["shell_rel_err"] < tol
                     and row["repeat_max_abs_diff"] == 0.0)
    return row


def shell_rel_err(torch, got, ref) -> float:
    """max |got - ref| / max |ref| over the dx voxels with some axis index
    in {0, 1, S-2, S-1}, where the reflect adjoint's sums and the split
    store's two destinations meet."""
    def axis(n):
        m = torch.zeros(n, dtype=torch.bool, device=got.device)
        m[[0, 1, n - 2, n - 1]] = True
        return m
    D, H, W = got.shape[1:4]
    m = axis(D)[:, None, None] | axis(H)[None, :, None] | axis(W)[None, None]
    g, r = got.float()[:, m], ref.float()[:, m]
    return (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)


def check_reflect_shell(kt, torch, dev, gen, B, S, C):
    """The reflect dgrad's shell pass at (B, S^3, C) on f32 g_ext, against
    its plain version (the same f32 sums in the same order, one rounding:
    bit for bit) on the same prefilled dx, which it must leave as it is off
    the shell; one `aten.reflection_pad3d_backward` (the whole fold) beside
    it. Bound: the shell's sources read once, its voxels written once."""
    g = torch.randn((B, S + 2, S + 2, S + 2, C), generator=gen, device=dev)
    dx0 = torch.randn((B, S, S, S, C), generator=gen, device=dev).to(
        torch.bfloat16)
    got = kt.pad_shell_ndhwc(g, dx0.clone())
    ref = kt.pad_shell_plain(g, dx0.clone())
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    dx = dx0.clone()
    n_shell, n_src = reflect_shell_counts(S)
    b_ms, b_by = bound(0.0, B * (n_src * C * 4 + n_shell * C * 2))
    return dict(shape=f"B{B} {S}^3x{C} f32 -> bf16 shell pass",
                max_abs_err=err, rel_err=rel, tol=TOL_EXACT,
                ok=rel <= TOL_EXACT,
                ms=cuda_ms(lambda: kt.pad_shell_ndhwc(g, dx)),
                plain_ms=cuda_ms(lambda: kt.pad_shell_plain(g, dx)),
                library_ms=cuda_ms(fold_library(torch, g)), bound_ms=b_ms,
                bound_by=b_by)


def step_dgrad_shapes(plan, S: int) -> list[tuple[int, int, int]]:
    """(extent, ci, co) of every conv of the train walk at crop `S` that
    takes an input gradient: every conv but the entry conv, whose input is
    the data. The walk halves the extent at each pool and doubles it at
    each upsample."""
    shapes, s, first = [], S, True
    for spec in plan.layers:
        if spec.kind == "pool":
            s //= 2
        elif spec.kind == "upsample":
            s *= 2
        elif spec.kind == "conv":
            if not first:
                shapes.append((s, spec.in_ch, spec.out_ch))
            first = False
    return shapes


def reflect_shell_counts(S: int) -> tuple[int, int]:
    """Per batch item of an S^3 volume: the shell's dx voxels (some axis
    index in {1, S-2}) and the extended-grid voxels they sum (some axis
    coordinate in {0, 2, S-1, S+1} of 0..S+1)."""
    inner = S - len({1, S - 2})
    ext_inner = S + 2 - len({0, 2, S - 1, S + 1})
    return S ** 3 - inner ** 3, (S + 2) ** 3 - ext_inner ** 3


def fold_library(torch, g):
    """One PyTorch call computing the reflect pad's adjoint of `g` (B,
    S+2, S+2, S+2, C) f32: `aten.reflection_pad3d_backward` on its NCDHW
    view."""
    B, s2, _, _, C = g.shape
    s = s2 - 2
    gc = g.permute(0, 4, 1, 2, 3)
    inp = torch.empty((B, s, s, s, C), dtype=g.dtype,
                      device=g.device).permute(0, 4, 1, 2, 3)
    return lambda: torch.ops.aten.reflection_pad3d_backward(gc, inp, [1] * 6)


# the record_function ranges of the loop, the step and registration;
# torch.profiler also lists each as a CUDA row spanning the kernels it
# enqueued, which is not device work of its own (nor is torch.optim's
# `Optimizer.step#...` range)
RANGES = ("loop/", "data/", "step/", "reg/", "seg/")


def is_device_work(ev) -> bool:
    from torch.autograd import DeviceType

    return ev.device_type == DeviceType.CUDA and not ev.key.startswith(
        RANGES + ("Optimizer.",))


def device_ms_by_kernel(torch, fn, reps: int = 10) -> dict:
    """Device ms per call of `fn` by kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and t > 0:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1e3 / reps
    return out


def run_dgrad_split(torch, kt, dev, B: int = 2, S: int = 128) -> dict:
    """`--dgrad-split`: each reflect input gradient of the 6M pretraining
    step at `PretrainConfig()` (the 19 convs of the walk but the entry
    conv, batch 2 at crop 128), its device time apart into the conv
    kernels, the reflect fold and the glue (the weights' flip, the zero
    bias), by kernel name from torch.profiler; the whole call by CUDA
    events; one `aten.reflection_pad3d_backward` on the same g; and the
    fold's bound by bytes, both as the full-grid fold (g read whole) and as
    the shell pass (only the shell's sources read). Then the whole step in
    rounds (`step_rounds`). Reads only `conv3x3x3_dgrad_ndhwc` and the
    step's entry points, so it also runs against an earlier checkout (copy
    this script into its root)."""
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

    plan = build_plan(UnetConfig(
        **ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"]))
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, tot = [], {}
    for s, ci, co in step_dgrad_shapes(plan, S):
        dy = torch.randn((B, s, s, s, co), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((27 * ci, co), generator=gen, device=dev)
             * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
        fn = lambda: kt.conv3x3x3_dgrad_ndhwc(  # noqa: E731
            dy, w, pad_type="reflect")
        by_kernel = device_ms_by_kernel(torch, fn)
        parts = {"conv": 0.0, "fold": 0.0, "glue": 0.0}
        for name, ms in by_kernel.items():
            part = ("fold" if "pad_adjoint" in name or "pad_shell" in name
                    else "conv" if "conv" in name or "splitk" in name
                    else "glue")
            parts[part] += ms
        g = torch.randn((B, s + 2, s + 2, s + 2, ci), generator=gen,
                        device=dev)
        lib_ms = cuda_ms(fold_library(torch, g))
        del g
        n_shell, n_src = reflect_shell_counts(s)
        row = dict(shape=f"B{B} {s}^3 {ci}->{co}", ms=cuda_ms(fn), **parts,
                   fold_library_ms=lib_ms,
                   fold_bound_ms=B * ((s + 2) ** 3 * ci * 4 + s ** 3 * ci * 2)
                   / PEAK_BYTES * 1e3,
                   shell_bound_ms=B * (n_src * ci * 4 + n_shell * ci * 2)
                   / PEAK_BYTES * 1e3,
                   kernels=by_kernel)
        rows.append(row)
        for k in ("ms", "conv", "fold", "glue", "fold_library_ms",
                  "fold_bound_ms", "shell_bound_ms"):
            tot[k] = tot.get(k, 0.0) + row[k]
        log(f"[dgrad-split] {row['shape']}: events {row['ms']:.4f} ms; "
            f"profiler conv {parts['conv']:.4f} fold {parts['fold']:.4f} "
            f"glue {parts['glue']:.4f} ms; fold library_ms {lib_ms:.4f}; "
            f"fold bound_ms {row['fold_bound_ms']:.4f} (full grid), "
            f"{row['shell_bound_ms']:.4f} (shell) (bytes)")
    log(f"[dgrad-split] the step's {len(rows)} reflect dgrads: " + ", ".join(
        f"{k} {v:.4f}" for k, v in tot.items()) + f" ms; {nvidia_smi()}")
    return dict(rows=rows, total=tot, step=step_rounds(torch, dev))


def step_rounds(torch, dev, rounds: int = 4) -> list[float]:
    """The 6M pretraining step at `PretrainConfig()` on the seeded batch,
    in rounds of five steps (CUDA events around each): each round's median
    of steps 2-5, the `[train-step128]` metric."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = PretrainConfig()
    _, _, state, step = build_all(cfg, 1000, device=dev)
    views, segs = train_batch(torch, dev, cfg.crop_size)
    medians = []
    for _ in range(rounds):
        ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, views, segs,
                            torch.Generator(device=dev).manual_seed(7))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        medians.append(statistics.median(ms[1:]))
    log(f"[dgrad-split] the 6M step, median of steps 2-5 in {rounds} rounds: "
        f"{medians} ms")
    return medians


# -----------------------------------------------------------------------------

def smooth_field(torch, dev, size: int, seed: int):
    """A smooth seeded (size^3) field in [0, 1]: Gaussian blobs, no noise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ax = torch.linspace(-1, 1, size, device=dev)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    vol = torch.zeros((size, size, size), device=dev)
    centers = torch.rand((8, 3), generator=gen, device=dev) * 1.6 - 0.8
    widths = 0.05 + 0.2 * torch.rand((8,), generator=gen, device=dev)
    for c, s in zip(centers, widths):
        vol += torch.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2
                           + (x - c[2]) ** 2) / s)
    return (vol - vol.min()) / (vol.max() - vol.min())


def synthetic_volume(torch, dev, size: int, seed: int):
    """A CT-like test volume in [0, 1]: smooth blobs plus noise, seeded."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ax = torch.linspace(-1, 1, size, device=dev)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    vol = torch.zeros((size, size, size), device=dev)
    centers = torch.rand((6, 3), generator=gen, device=dev) * 1.2 - 0.6
    for c in centers:
        r2 = (z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2
        vol += torch.exp(-r2 / 0.08)
    vol += 0.05 * torch.randn(vol.shape, generator=gen, device=dev)
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    return vol[None, ..., None].contiguous()


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def reset_counts(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def check_path(name, feats, shape, launched, needed):
    """Fail the run on a wrong shape, a non-finite value or a kernel of the
    path that was not launched."""
    import torch

    if tuple(feats.shape) != shape:
        raise RuntimeError(f"{name}: bad output shape {tuple(feats.shape)}")
    if not torch.isfinite(feats).all():
        raise RuntimeError(f"{name}: non-finite features")
    missing = [k for k in needed if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{name}: kernels not launched {missing}: "
                           f"{launched}")


def mean_cosine(a, b) -> float:
    """Mean over voxels of the cosine between two feature vectors."""
    num = (a * b).sum(-1)
    den = (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-12)
    return (num / den).mean().item()


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0


def profile_sliding(torch, make_feature_extractor, plan, sd, dev, out_dir,
                    tag="6m"):
    """Kernel time by name and the device's busy share over the sliding
    path on 160^3 (27 windows, 14 chunks of 2), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    vol = synthetic_volume(torch, dev, 160, seed=2)
    sliding = make_feature_extractor(
        plan, sd, strategy="sliding", device=dev, sw_batch_size=2)
    sliding(vol)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sliding(vol)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    # device-side rows only (kernels, copies); CPU ops repeat their time
    rows = sorted(
        ((getattr(ev, attr) / 1e3, ev.count, ev.key) for ev in events
         if ev.device_type == DeviceType.CUDA and getattr(ev, attr) > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, f"profile_sliding160_{tag}.txt"),
              "w") as f:
        f.write(events.table(sort_by=attr, row_limit=40))
    log(f"[profile] {tag} sliding 160^3: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for ms, count, key in rows[:16]:
        log(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[dict(ms=r[0], count=r[1], name=r[2]) for r in rows[:20]])


def main(argv) -> int:
    quick = "--quick" in argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "anatomix_tpu_torch")):
        print("chip_smoke: run from a checkout holding anatomix_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.kernels import attention as ka
    from anatomix_tpu_torch.kernels import build
    from anatomix_tpu_torch.kernels import conv as kc
    from anatomix_tpu_torch.kernels import conv_down as kd
    from anatomix_tpu_torch.kernels import conv_train as kt
    from anatomix_tpu_torch.kernels import norm as kn
    from anatomix_tpu_torch.kernels import reshuffle as kr8
    from anatomix_tpu_torch.kernels import resize as kr
    from anatomix_tpu_torch.kernels import scatter as ks
    from anatomix_tpu_torch.models.load import load_model
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.models.vit3d import (
        Primus,
        init_primus_params,
        primus_config,
    )
    from anatomix_tpu_torch.ops import norms
    from anatomix_tpu_torch.ops import sliding_window as sw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    report = {"device": kind, "nvidia_smi": smi}
    t_start = time.perf_counter()

    # phase 1: build every kernel library, one nvcc per source in parallel
    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s for {list(build.SOURCES)}")
    for name, text in build.build_logs.items():
        for line in ptxas_report(text):
            log(f"[build:{name}] {line}")

    if "--conv-time" in argv:
        report["conv_time"] = run_conv_time(torch, kc, kt, dev)
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "conv_time.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"conv_time": report["conv_time"]}), flush=True)
        return 0

    if "--dgrad-split" in argv:
        report["dgrad_split"] = run_dgrad_split(torch, kt, dev)
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "dgrad_split.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    wrappers = {
        "conv3x3x3_ndhwc": kc.conv3x3x3_ndhwc,
        "conv3x3x3_upcat_ndhwc": kc.conv3x3x3_upcat_ndhwc,
        "blend_scatter": ks.blend_scatter,
        "conv3x3x3_cat_ndhwc": kc.conv3x3x3_cat_ndhwc,
        "upsample2x_trilinear_ndhwc": kr.upsample2x_trilinear_ndhwc,
        "norm_apply_ndhwc": kn.norm_apply_ndhwc,
        "conv_down2_ndhwc": kd.conv_down2_ndhwc,
        "flash_attention": ka.flash_attention,
        "depth_to_space8_ndhwc": kr8.depth_to_space8_ndhwc,
        "conv3x3x3_wgrad_ndhwc": kt.conv3x3x3_wgrad_ndhwc,
        "conv3x3x3_dgrad_ndhwc": kt.conv3x3x3_dgrad_ndhwc,
        "space_to_depth2_ndhwc": kr8.space_to_depth2_ndhwc,
        "depth_to_space2_ndhwc": kr8.depth_to_space2_ndhwc,
        "flash_attention_bwd_dkv": ka.flash_attention_bwd_dkv,
        "flash_attention_bwd_dq": ka.flash_attention_bwd_dq,
        "depth_to_space_fold_ndhwc": kr8.depth_to_space_fold_ndhwc,
        "depth_to_space_interleave_ndhwc":
            kr8.depth_to_space_interleave_ndhwc,
        "space_to_depth_c1_ndhwc": kr8.space_to_depth_c1_ndhwc,
        "pad_shell_ndhwc": kt.pad_shell_ndhwc,
        "conv3x3x3_dvalid_ndhwc": kc.conv3x3x3_dvalid_ndhwc,
    }

    if "--parallel" in argv:
        # phase 1, K1's D-valid rows, then the parallel phases alone
        gen = torch.Generator(device=dev).manual_seed(0)
        checks = {"conv3x3x3_dvalid_ndhwc": dvalid_checks(kc, torch, F, dev,
                                                          gen)}
        failed = log_kernel_rows(checks)
        if failed:
            raise RuntimeError(f"kernel disagrees with its plain version: "
                               f"{failed}")
        kwargs = ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"]
        plan, sd = load_model(
            "scratch", allow_scratch=True, seed=0, device=dev,
            num_downs=kwargs["num_downs"], ngf=kwargs["ngf"],
            output_nc=kwargs["output_nc"])
        paths = {}
        report["checks"] = checks
        report["parallel"] = run_parallel(
            torch, dev, make_feature_extractor, wrappers, paths, plan, sd,
            synthetic_volume(torch, dev, 256, seed=1), report, init_params,
            build_plan(UnetConfig(**ANATOMIX_VARIANTS["anatomix-dev"]
                                  ["unet_kwargs"])))
        report["paths"] = paths
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_parallel.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    if "--options" in argv:
        # phase 1, then phase 14 alone: the new kernel modes, the options
        # paths and steps
        checks = options_kernel_checks(kc, kt, kn, norms, torch, F, dev)
        report["checks"] = checks
        failed = log_kernel_rows(checks)
        if failed:
            raise RuntimeError(f"kernel disagrees with its plain version: "
                               f"{failed}")
        paths = {}
        report["options"] = run_options(torch, dev, make_feature_extractor,
                                        wrappers, paths, kt)
        report["paths"] = paths
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_options.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    if "--segmentation" in argv:
        # phase 1, then phase 11's 6M part alone (`--dev-train` runs the
        # dev part)
        kwargs = ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"]
        splan = build_plan(UnetConfig(**kwargs))
        paths = {}
        report.update(run_segmentation_phases(torch, dev, wrappers, paths,
                                              kt, splan, dev_backbone=False))
        report["paths"] = paths
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_segmentation.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    if "--dev-train" in argv:
        # phase 1, the dev widths' backward kernels, then the dev training
        # phases alone (phase 7b and phase 11's dev part)
        gen = torch.Generator(device=dev).manual_seed(0)
        checks = dev_backward_checks(kt, torch, F, dev, gen)
        failed = log_kernel_rows(checks)
        if failed:
            raise RuntimeError(f"kernel disagrees with its plain version: "
                               f"{failed}")
        report["checks"] = checks
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        if "--profile" in argv:
            # the dev step, one dev finetuning step and one validation
            report["profile_dev_train"] = profile_train(torch, dev, out_dir,
                                                        netG="dev")
            report["profile_dev_segmentation"] = profile_dev_segmentation(
                torch, dev, out_dir)
            with open(os.path.join(out_dir, "chip_dev_profile.json"),
                      "w") as f:
                json.dump(report, f, indent=1)
            return 0
        paths = {}
        report["dev_train"] = run_dev_train(torch, dev, wrappers, paths, kt)
        report.update(run_segmentation_phases(
            torch, dev, wrappers, paths, kt, None, six_m=False))
        report["paths"] = paths
        with open(os.path.join(out_dir, "chip_dev_train.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    # phase 2: kernels vs plain at the main paths' shapes
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {name: [] for name in wrappers}
    # the sliding path's shapes: chunks of sw_batch 2 windows of 128^3
    for B, S, ci, co, f32 in [
        (2, 128, 1, 16, False),    # entry conv
        (2, 128, 16, 16, False),
        (2, 32, 64, 64, False),
        (2, 8, 256, 256, False),
        (2, 128, 16, 16, True),    # exit conv, f32 store
        # the dev UNet on the three-term split (3 Ci), each feeding a norm
        # (f32 store): full-resolution level, 8^3 level, 4^3 bottleneck
        (2, 128, 3 * 32, 32, True),
        (2, 8, 3 * 512, 512, True),
        (2, 4, 3 * 1024, 1024, True),
    ]:
        checks["conv3x3x3_ndhwc"].append(
            check_conv(kc, torch, F, dev, gen, B, S, ci, co, f32))
    # the ViT tokenizer on the three-term split: the stem on the volume, a
    # stage conv; zero padding, f32 store
    for B, S, ci, co in [(2, 128, 3, 32), (2, 64, 3 * 64, 64)]:
        checks["conv3x3x3_ndhwc"].append(check_conv(
            kc, torch, F, dev, gen, B, S, ci, co, True, pad="zeros"))
    for B, S, c1, c2, co in [
        (2, 16, 128, 256, 128), (2, 32, 64, 128, 64),
        (2, 64, 32, 64, 32), (2, 128, 16, 32, 16),
    ]:
        checks["conv3x3x3_upcat_ndhwc"].append(
            check_upcat(kc, torch, F, dev, gen, B, S, c1, c2, co))
    checks["blend_scatter"].append(check_scatter(ks, sw, torch, dev, gen))
    checks["blend_scatter"].append(
        check_scatter(ks, sw, torch, dev, gen, C=32))
    # the ViT's fold exit hands the stitch bf16 windows
    checks["blend_scatter"].append(check_scatter(
        ks, sw, torch, dev, gen, C=32, win_dtype=torch.bfloat16))
    # segmentation's validation: n_classes + 1 = 5 logit channels, constant
    checks["blend_scatter"].append(check_scatter(
        ks, sw, torch, dev, gen, C=SEG_CLASSES + 1, mode="constant"))
    # the dev decoder's convs on the split operands (3 c1 + 3 c2)
    for B, S, c1, c2, co in [
        (2, 128, 3 * 32, 3 * 64, 32), (2, 32, 3 * 128, 3 * 256, 128),
        (2, 8, 3 * 512, 3 * 1024, 512),
    ]:
        checks["conv3x3x3_cat_ndhwc"].append(
            check_cat(kc, torch, F, dev, gen, B, S, c1, c2, co))
    for B, s, C in [(2, 64, 64), (2, 4, 1024)]:
        checks["upsample2x_trilinear_ndhwc"].append(
            check_upsample(kr, torch, F, dev, gen, B, s, C, split=True))
    for B, S, tiles, act in [
        (2, 128, (1, 1, 1), "relu"),     # sliding: per-window stats
        (1, 256, (2, 2, 2), "relu"),     # full_tiled 256^3
        (2, 40, (3, 3, 3), "relu"),      # uneven tiles
    ]:
        checks["norm_apply_ndhwc"].append(check_norm_apply(
            kn, norms, torch, dev, gen, B, S, 32, tiles, act))
    # the ViT tokenizer's IN + residual + lrelu(0.01), stage 0
    checks["norm_apply_ndhwc"].append(check_norm_apply(
        kn, norms, torch, dev, gen, 2, 64, 64, (1, 1, 1), "lrelu",
        residual=True))
    # the ViT's three stride-2 tokenizer stages (on the split, 3 Ci), its
    # attention and its exit
    for B, S, ci, co in [(2, 128, 3 * 32, 64), (2, 64, 3 * 64, 128),
                         (2, 32, 3 * 128, 256)]:
        checks["conv_down2_ndhwc"].append(
            check_conv_down(kc, kd, torch, F, dev, gen, B, S, ci, co))
    for B, H, N, hd in [(2, 6, 4104, 66), (1, 6, 4104, 66)]:
        checks["flash_attention"].append(
            check_attention(ka, torch, F, dev, gen, B, H, N, hd))
    # the ViT step: the forward with its lse, then dkv and dq, at the step's
    # shape and at a ragged N (two keys past a tile)
    checks["flash_attention"].append(
        check_attention_lse(ka, torch, dev, gen, 2, 6, 4104, 66))
    for B, H, N, hd in [(2, 6, 4104, 66), (2, 6, 130, 66)]:
        for name, row in check_attention_bwd(ka, torch, F, dev, gen, B, H,
                                             N, hd).items():
            checks[name].append(row)
    for with_sub in (True, False):
        checks["depth_to_space8_ndhwc"].append(
            check_d2s8(kr8, torch, dev, gen, 2, 16, 32, with_sub))
    # the pretraining step's conv backward: the 6M UNet's full-resolution
    # conv, its decoder concat, the 64^3 decoder, the bottleneck; the entry
    # conv (Ci = 1) takes no dx
    for B, S, ci, co in [(2, 128, 16, 16), (2, 128, 48, 16), (2, 64, 96, 32),
                         (2, 8, 256, 256), (2, 128, 1, 16)]:
        for which in ("wgrad", "dgrad"):
            if which == "dgrad" and ci == 1:
                continue
            checks[f"conv3x3x3_{which}_ndhwc"].append(check_conv_backward(
                kt, torch, F, dev, gen, B, S, ci, co, which))
    # the reflect dgrad's shell pass at the step's 128^3 (ci 16, 48) and
    # 64^3 (ci 96) shapes
    for B, S, C in [(2, 128, 16), (2, 128, 48), (2, 64, 96)]:
        checks["pad_shell_ndhwc"].append(
            check_reflect_shell(kt, torch, dev, gen, B, S, C))
    # the ViT step's tokenizer (zero padding): the stem on (hi, lo) (no
    # dx), a residual conv per stage; then the three stride-2 convs'
    # backward in the kernels' stride-2 mode (dy on its own grid)
    for B, S, ci, co, stride2 in [(2, 128, 2, 32, False),
                                  (2, 64, 64, 64, False),
                                  (2, 32, 128, 128, False),
                                  (2, 16, 256, 256, False),
                                  (2, 128, 32, 64, True),
                                  (2, 64, 64, 128, True),
                                  (2, 32, 128, 256, True)]:
        for which in ("wgrad", "dgrad"):
            if which == "dgrad" and ci == 2:
                continue
            checks[f"conv3x3x3_{which}_ndhwc"].append(check_conv_backward(
                kt, torch, F, dev, gen, B, S, ci, co, which, pad="zeros",
                stride2=stride2))
    # the step's block-layout permutations: the first and last pools'
    # inputs, the last upsample's gradient (s2d); the last upsample, the
    # first pool's gradient, the first upsample (d2s)
    for which, B, S, C in [("s2d", 2, 128, 16), ("s2d", 2, 16, 128),
                           ("s2d", 2, 128, 32), ("d2s", 2, 128, 32),
                           ("d2s", 2, 128, 16), ("d2s", 2, 16, 256)]:
        name = ("space_to_depth2_ndhwc" if which == "s2d"
                else "depth_to_space2_ndhwc")
        checks[name].append(check_reshuffle2(kr8, torch, dev, gen, B, S, C,
                                             which))
    # the ViT stage decoder's odd middle widths (99 at patch 8, 49 at 16)
    for which, B, S, C in [("d2s", 2, 64, 99), ("d2s", 2, 64, 49),
                           ("s2d", 2, 64, 8)]:
        name = ("space_to_depth2_ndhwc" if which == "s2d"
                else "depth_to_space2_ndhwc")
        checks[name].append(check_reshuffle2(kr8, torch, dev, gen, B, S, C,
                                             which))
    # the stage decoder's exits at the ViT sliding window's last stage: the
    # fold rows in bf16 (the stitch's input), the spatial f32 volume
    checks["depth_to_space_fold_ndhwc"].append(check_d2s_sub(
        kr8, torch, dev, gen, 2, 64, 32, "fold", torch.bfloat16,
        torch.bfloat16))
    checks["depth_to_space_interleave_ndhwc"].append(check_d2s_sub(
        kr8, torch, dev, gen, 2, 64, 32, "interleave", torch.bfloat16,
        torch.float32))
    # the v1 tokenizer's entry: the f32 window (the path's), and bf16
    for dtype in (torch.float32, torch.bfloat16):
        checks["space_to_depth_c1_ndhwc"].append(check_c1(
            kr8, torch, dev, gen, 2, 128, dtype))
    # the dev pretraining step's and dev finetuning's backward widths
    for name, rows in dev_backward_checks(kt, torch, F, dev, gen).items():
        checks[name] += rows
    # K1's D-valid mode at the spatially sharded paths' shapes
    checks["conv3x3x3_dvalid_ndhwc"] += dvalid_checks(kc, torch, F, dev, gen)
    failed = log_kernel_rows(checks)
    report["checks"] = checks
    failed += check_attention_ragged(ka, torch, dev, gen)
    # the forward conv stays the same bits from run to run (split K sums
    # its partials in a fixed order): two launches of the dev bottleneck
    report["determinism"] = check_determinism(kc, torch, dev, gen)
    log(f"[determinism] conv3x3x3_ndhwc B2 4^3 3072->1024 f32-out, split "
        f"{report['determinism']['splits']}: two launches max|diff| "
        f"{report['determinism']['max_abs_diff']}")
    if report["determinism"]["max_abs_diff"] != 0.0:
        failed.append("conv3x3x3_ndhwc determinism")
    # and V2 at its split-K stage
    report["determinism_down2"] = check_conv_down_determinism(kd, torch, dev,
                                                              gen)
    splits = kc.conv_plan(2, (16, 16, 16), 384, 256, mode=kc.MODE_S2).splits
    log(f"[determinism] conv_down2_ndhwc B2 32^3x384 -> 16^3x256 f32-out, "
        f"split {splits}: two launches max|diff| {report['determinism_down2']}")
    if report["determinism_down2"] != 0.0:
        failed.append("conv_down2_ndhwc determinism")
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version: {failed}")
    torch.cuda.empty_cache()
    if quick:
        return 0
    if "--bisect" in argv:
        report["p1_bisect"] = p1_bisect(torch, dev)
        for variant in ("anatomix", "anatomix-dev"):
            uplan = build_plan(UnetConfig(
                **ANATOMIX_VARIANTS[variant]["unet_kwargs"]))
            usd = {k: v.to(dev) for k, v in init_params(
                uplan, torch.Generator().manual_seed(0)).items()}
            report[f"smooth_{variant}"] = unet_fwd_check(
                torch, make_feature_extractor, uplan, usd, dev, variant)
            del usd
        return 0

    # phase 3: the 6M model at full width, `full` on 256^3
    kwargs = ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"]
    plan, sd = load_model(
        "scratch", allow_scratch=True, seed=0, device=dev,
        num_downs=kwargs["num_downs"], ngf=kwargs["ngf"],
        output_nc=kwargs["output_nc"],
    )
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if "--profile" in argv:
        report["profile"] = profile_sliding(
            torch, make_feature_extractor, plan, sd, dev, out_dir)
        dplan = build_plan(UnetConfig(
            **ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]))
        dsd = {k: v.to(dev) for k, v in init_params(
            dplan, torch.Generator().manual_seed(0)).items()}
        report["profile_dev"] = profile_sliding(
            torch, make_feature_extractor, dplan, dsd, dev, out_dir, "dev")
        del dsd
        vcfg = primus_config(
            ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"])
        vsd = {k: v.to(dev) for k, v in init_primus_params(
            vcfg, torch.Generator().manual_seed(0)).items()}
        report["profile_vit"] = profile_sliding(
            torch, make_feature_extractor, vcfg, vsd, dev, out_dir, "vit")
        del vsd
        report["profile_train"] = profile_train(torch, dev, out_dir)
        report["profile_vit_train"] = profile_train(torch, dev, out_dir,
                                                    netG="primus")
        report["profile_dev_train"] = profile_train(torch, dev, out_dir,
                                                    netG="dev")
        report["profile_train_loop"] = profile_train_loop(
            torch, dev, out_dir, loop_data(torch, dev))
        report["profile_registration"] = profile_registration(
            torch, dev, out_dir, plan, sd)
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            report["profile_segmentation"] = profile_segmentation(
                torch, dev, out_dir,
                seeded_pth(torch, plan, os.path.join(tmp, "seed0.pth")),
                seg_dataset(os.path.join(tmp, "data")))
        report["profile_dev_segmentation"] = profile_dev_segmentation(
            torch, dev, out_dir)
        with open(os.path.join(out_dir, "chip_profile.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0
    paths = {}  # launches per path, each counted from 0
    vol256 = synthetic_volume(torch, dev, 256, seed=1)
    full = make_feature_extractor(plan, sd, strategy="full", device=dev)
    full(vol256[:, :32, :32, :32])  # first call: kernel libraries loaded
    torch.cuda.synchronize()
    reset_counts(wrappers)
    feats, full_s = timed(torch, lambda: full(vol256))
    full_counts = paths["full_256"] = counts(wrappers)
    log(f"[full] 256^3 -> {tuple(feats.shape)} in {full_s:.4f} s, "
        f"launches {full_counts}")
    check_path("full", feats, (1, 256, 256, 256, 16), full_counts,
               ["conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc"])
    plain_full = make_feature_extractor(plan, sd, strategy="full",
                                        impl="eager", device=dev)
    ref, plain_full_s = timed(torch, lambda: plain_full(vol256))
    e = model_err(feats, ref)
    log(f"[full] vs plain f32 path: mean|err|/std {e['mean_err_over_std']:.3e}"
        f" (tol {TOL_MODEL}), max_abs_err {e['max_abs_err']:.3e}, "
        f"max/max {e['max_err_over_max']:.3e}; plain {plain_full_s:.4f} s")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"full: error {e} over {TOL_MODEL}")
    report["full"] = dict(seconds=full_s, launches=full_counts,
                          plain_seconds=plain_full_s, **e)
    del feats, ref, plain_full
    # one 128^3 forward (B=1), the unit of the sliding path, by CUDA events
    vol128 = vol256[:, :128, :128, :128].contiguous()
    reset_counts(wrappers)
    full(vol128)
    fwd_counts = counts(wrappers)
    fwd_ms = cuda_ms(lambda: full(vol128))
    eager128 = make_feature_extractor(plan, sd, strategy="full",
                                      impl="eager", device=dev)
    fwd_plain_ms = cuda_ms(lambda: eager128(vol128))
    log(f"[fwd128] 6M forward 128^3 B=1: kernels {fwd_ms:.4f} ms, plain f32 "
        f"path {fwd_plain_ms:.4f} ms, launches {fwd_counts}")
    del eager128
    # the forward on the smooth field and the noisy volume, against the f32
    # plain path and the plain path in bf16
    fc = unet_fwd_check(torch, make_feature_extractor, plan, sd, dev,
                        "fwd128")
    for name, r in fc.items():
        two_part_gate(f"fwd128 {name}", r["kernels"], r["plain_bf16"])
    report["fwd128"] = dict(ms=fwd_ms, plain_ms=fwd_plain_ms,
                            launches=fwd_counts, check=fc)

    # phase 4: reference-setting sliding window, 343 windows on 256^3
    sw_kw = dict(strategy="sliding", roi_size=(128, 128, 128),
                 overlap=0.8, mode="gaussian", sigma_scale=0.25,
                 sw_batch_size=2)
    sliding = make_feature_extractor(plan, sd, device=dev, **sw_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    feats, slide_s = timed(torch, lambda: sliding(vol256))
    slide_counts = paths["sliding_256"] = counts(wrappers)
    n_win = len(sw.compute_window_starts((256,) * 3, (128,) * 3, 0.8))
    log(f"[sliding] 256^3, {n_win} windows -> {tuple(feats.shape)} in "
        f"{slide_s:.4f} s, launches {slide_counts}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_path("sliding", feats, (1, 256, 256, 256, 16), slide_counts,
               ["conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc",
                "blend_scatter"])
    del feats
    vol160 = synthetic_volume(torch, dev, 160, seed=2)
    got = sliding(vol160)
    ref = make_feature_extractor(plan, sd, device=dev, impl="eager",
                                 **sw_kw)(vol160)
    e = model_err(got, ref)
    log(f"[sliding] 160^3 (27 windows) vs plain f32 path: mean|err|/std "
        f"{e['mean_err_over_std']:.3e} (tol {TOL_MODEL}), max_abs_err "
        f"{e['max_abs_err']:.3e}, max/max {e['max_err_over_max']:.3e}")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"sliding: error {e} over {TOL_MODEL}")
    report["sliding"] = dict(seconds=slide_s, windows=n_win,
                             launches=slide_counts, check_160=e)
    del got, ref, sliding, full
    torch.cuda.empty_cache()

    # phase 5: the 94M dev UNet at full width and depth, seeded weights
    report["dev"] = run_dev(
        torch, dev, make_feature_extractor, wrappers, paths,
        build_plan(UnetConfig(**ANATOMIX_VARIANTS["anatomix-dev"]
                              ["unet_kwargs"])),
        init_params, vol256, vol128, vol160, sw_kw, sw)

    # phase 6: the 26M ViT at full width and depth, seeded weights
    report["vit"] = run_vit(
        torch, dev, make_feature_extractor, wrappers, paths,
        primus_config(ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"]),
        init_primus_params, Primus, vol256, vol128, vol160, sw_kw, sw)

    # phase 6b: the v1 ViT, patch 8 (fold route) and 16 (interleave exit)
    from anatomix_tpu_torch.models.vit3d import PrimusConfig
    for patch in (8, 16):
        report[f"vit1_p{patch}"] = run_vit1(
            torch, dev, make_feature_extractor, wrappers, paths,
            ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"],
            init_primus_params, Primus, PrimusConfig, vol128, patch)

    # phase 6c: P1, where the bf16 ViT's error on a smooth volume comes from
    report["p1_bisect"] = p1_bisect(torch, dev)

    # phase 7: the 6M pretraining step at the reference configuration
    report["train"] = run_train(torch, dev, wrappers, paths, kt)

    # phase 7b: the 94M dev UNet's pretraining step (the general walk)
    report["dev_train"] = run_dev_train(torch, dev, wrappers, paths, kt)

    # phase 8: the 26M ViT's pretraining step
    report["vit_train"] = run_vit_train(torch, dev, wrappers, paths, ka)

    # phase 9: the trainer loop (input pipeline included), its multi-step
    # gate against the plain route, and the ViT's loop
    data = loop_data(torch, dev)
    report["train_loop"] = run_train_loop(
        torch, dev, wrappers, paths, data, report["train"]["median_step_ms"])
    report["train_loop_gate"] = run_train_loop_gate(torch, dev, data)
    report["vit_train_loop"] = run_vit_train_loop(torch, dev, wrappers,
                                                  paths, data)
    del data

    # phase 10: registration (ConvexAdam on the 6M UNet's features)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = seeded_pth(torch, plan, os.path.join(tmp, "anatomix_seed0.pth"))
        rplan, rsd = load_model(ckpt_path=ckpt, device=dev)
        report["registration"] = run_registration(torch, dev, wrappers, paths,
                                                  rplan, rsd)
        pair = structured_pair(torch, dev, REG_SIZE)
        report["registration_gate"] = run_registration_gate(
            torch, dev, wrappers, paths, rplan, rsd, pair)
        report["registration_cli"] = run_registration_cli(
            torch, dev, wrappers, paths, ckpt, pair)
    del rsd, pair
    torch.cuda.empty_cache()

    # phase 11: few-shot segmentation finetuning of the 6M and the dev
    # backbone (the step, validation, the gate against the plain route, the
    # CLI)
    report.update(run_segmentation_phases(torch, dev, wrappers, paths, kt,
                                          plan))

    # phase 12: the parallel paths (world 1 on one card) and the dry run
    report["parallel"] = run_parallel(
        torch, dev, make_feature_extractor, wrappers, paths, plan, sd, vol256,
        report, init_params,
        build_plan(UnetConfig(**ANATOMIX_VARIANTS["anatomix-dev"]
                              ["unet_kwargs"])))
    # phase 14: every UNet option on the kernels (their new modes first),
    # and the ordered T-w's repeats
    rows = options_kernel_checks(kc, kt, kn, norms, torch, F, dev)
    failed = log_kernel_rows(rows)
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{failed}")
    for name, extra in rows.items():
        checks[name] += extra
    report["options"] = run_options(torch, dev, make_feature_extractor,
                                     wrappers, paths, kt)

    for name in wrappers:
        log(f"[launches] {name}: " + ", ".join(
            f"{p} {v[name]}" for p, v in paths.items()))

    # phase 13: the kernels line
    replaces = {
        "conv3x3x3_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block.py:248 "
            "conv_block_sparse_halo (+ _halo_wide :404, _valid :886, "
            "_valid_wide :530); anatomix_tpu/ops/pallas/conv3x3.py:145 "
            "_conv3x3_valid"),
        "conv3x3x3_upcat_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block.py:1563 "
            "conv_block_skip_halo (+ _halo_wide :1696, _valid :1873)"),
        "blend_scatter": "anatomix_tpu/ops/pallas/scatter.py:128 "
                         "blend_scatter_fold",
        "conv3x3x3_cat_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block.py:1166 "
            "conv_block_sparse_cat_halo (+ _halo_wide :1278)"),
        "upsample2x_trilinear_ndhwc": (
            "anatomix_tpu/ops/pallas/upsample.py:75 "
            "upsample2x_trilinear_block_pallas"),
        "norm_apply_ndhwc": "anatomix_tpu/ops/pallas/norm_apply.py:46 "
                            "norm_apply_block",
        "conv_down2_ndhwc": "anatomix_tpu/ops/pallas/conv_down.py:178 "
                            "conv_down2_block",
        "flash_attention": "anatomix_tpu/models/vit3d/primus.py:322 "
                           "_flash_attention",
        "depth_to_space8_ndhwc": "anatomix_tpu/ops/pallas/reshuffle.py:478 "
                                 "depth_to_space8",
        "conv3x3x3_wgrad_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block_train.py:289 "
            "_wgrad_halo_wide (+ _wgrad_halo :362, _wgrad :444)"),
        "conv3x3x3_dgrad_ndhwc": "anatomix_tpu/ops/pallas/conv_block.py:691 "
                                 "conv_block_sparse_dx",
        "space_to_depth2_ndhwc": "anatomix_tpu/ops/pallas/reshuffle.py:620 "
                                 "space_to_depth",
        "depth_to_space2_ndhwc": "anatomix_tpu/ops/pallas/reshuffle.py:90 "
                                 "depth_to_space",
        "flash_attention_bwd_dkv": (
            "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
            "_flash_attention_bwd_dkv (reached through "
            "anatomix_tpu/models/vit3d/primus.py:322 under jax.grad)"),
        "flash_attention_bwd_dq": (
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
            "_flash_attention_bwd_dq (reached through "
            "anatomix_tpu/models/vit3d/primus.py:322 under jax.grad)"),
        "depth_to_space_fold_ndhwc": "anatomix_tpu/ops/pallas/reshuffle.py"
                                     ":305 depth_to_space_fold",
        "depth_to_space_interleave_ndhwc": (
            "anatomix_tpu/ops/pallas/reshuffle.py:194 "
            "depth_to_space_interleave"),
        "space_to_depth_c1_ndhwc": "anatomix_tpu/ops/pallas/reshuffle.py:580"
                                   " space_to_depth_c1",
        "pad_shell_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block.py:691 conv_block_sparse_dx "
            "(the reflect pad adjoint its caller takes, "
            "anatomix_tpu/ops/pallas/conv_block_train.py:678-683)"),
        "conv3x3x3_dvalid_ndhwc": (
            "anatomix_tpu/ops/pallas/conv_block.py:248 conv_block_sparse_halo "
            "(K1), in the JAX package's spatially sharded conv: the halo "
            "pad, then a VALID conv (anatomix_tpu/models/unet.py:428-455)"),
    }
    csrc = "anatomix_tpu_torch/kernels/csrc/"
    sources = {
        "conv3x3x3_ndhwc": csrc + "conv3d.cu",
        "conv3x3x3_upcat_ndhwc": csrc + "conv3d.cu",
        "blend_scatter": csrc + "blend_scatter.cu",
        "conv3x3x3_cat_ndhwc": csrc + "conv3d.cu",
        "upsample2x_trilinear_ndhwc": csrc + "upsample.cu",
        "norm_apply_ndhwc": csrc + "norm_apply.cu",
        "conv_down2_ndhwc": csrc + "conv3d.cu",
        "flash_attention": csrc + "flash_attention.cu",
        "depth_to_space8_ndhwc": csrc + "depth_to_space8.cu",
        "conv3x3x3_wgrad_ndhwc": csrc + "conv3d_wgrad.cu",
        "conv3x3x3_dgrad_ndhwc": csrc + "conv3d.cu",
        "space_to_depth2_ndhwc": csrc + "reshuffle.cu",
        "depth_to_space2_ndhwc": csrc + "reshuffle.cu",
        "flash_attention_bwd_dkv": csrc + "flash_attention.cu",
        "flash_attention_bwd_dq": csrc + "flash_attention.cu",
        "depth_to_space_fold_ndhwc": csrc + "reshuffle.cu",
        "depth_to_space_interleave_ndhwc": csrc + "reshuffle.cu",
        "space_to_depth_c1_ndhwc": csrc + "reshuffle.cu",
        "pad_shell_ndhwc": csrc + "conv3d.cu",
        "conv3x3x3_dvalid_ndhwc": csrc + "conv3d.cu",
    }
    # the line reports each kernel at its dominant main-path shape: the
    # 16-channel 128^3 conv, the 48->16 decoder conv, the ViT's bf16 stitch
    # chunk, the dev split [96+192]->32 decoder conv, the split 64^3 ->
    # 128^3 upsample, the split global norm of a 128^3 window pair, the ViT's
    # first split stride-2 stage, its attention at B2 and the block-space
    # exit with the demean subtract, the backward of the 16-channel 128^3
    # conv, the first pool's space-to-depth and the last upsample's
    # depth-to-space, the ViT step's attention backward, the ViT window's
    # fold and interleave exits, the f32 v1 entry, the reflect shell pass
    # of the 16-channel 128^3 dgrad, K1's D-valid mode at the 6M `full`'s
    # 16-channel 256^3 conv
    headline = {"conv3x3x3_ndhwc": 1, "conv3x3x3_upcat_ndhwc": 3,
                "blend_scatter": 2, "conv3x3x3_cat_ndhwc": 0,
                "upsample2x_trilinear_ndhwc": 0, "norm_apply_ndhwc": 0,
                "conv_down2_ndhwc": 0, "flash_attention": 0,
                "depth_to_space8_ndhwc": 0, "conv3x3x3_wgrad_ndhwc": 0,
                "conv3x3x3_dgrad_ndhwc": 0, "space_to_depth2_ndhwc": 0,
                "depth_to_space2_ndhwc": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_dq": 0, "depth_to_space_fold_ndhwc": 0,
                "depth_to_space_interleave_ndhwc": 0,
                "space_to_depth_c1_ndhwc": 0, "pad_shell_ndhwc": 0,
                "conv3x3x3_dvalid_ndhwc": 0}
    kernels = []
    for name, rows in checks.items():
        row = rows[headline[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "shape": row["shape"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
        if name == "conv3x3x3_dgrad_ndhwc":
            # reflect padding: the split store, then the shell pass
            kernels[-1]["shell_pass"] = "pad_shell_ndhwc"
            kernels[-1]["reflect_split_ms"] = {
                "conv": row["conv_ms"], "fold": row["fold_ms"]}
    report["kernels"] = kernels
    report["paths"] = paths
    report["total_s"] = time.perf_counter() - t_start
    log(f"[total] {report['total_s']:.1f} s after the device check")
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(nvidia_smi())
    print(json.dumps({"kernels": kernels}), flush=True)
    return 0


def run_dev(torch, dev, make_feature_extractor, wrappers, paths, dplan,
            init_params, vol256, vol128, vol160, sw_kw, sw):
    """Phase 5: the 94M dev UNet (registry `anatomix-dev`: ngf 32,
    num_downs 5, instance norm eps 1e-2, Avg pool, trilinear) at full width
    and depth with seeded weights, on each of its paths."""
    dev_needed = ["conv3x3x3_ndhwc", "conv3x3x3_cat_ndhwc",
                  "upsample2x_trilinear_ndhwc", "norm_apply_ndhwc"]
    dsd = {k: v.to(dev) for k, v in
           init_params(dplan, torch.Generator().manual_seed(0)).items()}
    n_params = sum(v.numel() for v in dsd.values())
    out = {"params": n_params}
    log(f"[dev] anatomix-dev: {n_params} parameters, "
        f"{len(dplan.conv_indices)} convs")

    # one B=1 forward at 128^3 (global statistics), by CUDA events
    dfull = make_feature_extractor(dplan, dsd, strategy="full", device=dev)
    dfull(vol128)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    y = dfull(vol128)
    torch.cuda.synchronize()
    c = paths["dev_fwd128"] = counts(wrappers)
    check_path("dev-fwd128", y, (1, 128, 128, 128, 32), c, dev_needed)
    ms = cuda_ms(lambda: dfull(vol128))
    deager = make_feature_extractor(dplan, dsd, strategy="full",
                                    impl="eager", device=dev)
    e = model_err(y, deager(vol128))
    plain_ms = cuda_ms(lambda: deager(vol128))
    log(f"[dev-fwd128] 94M forward 128^3 B=1: kernels {ms:.4f} ms, plain "
        f"f32 path {plain_ms:.4f} ms; vs plain mean|err|/std "
        f"{e['mean_err_over_std']:.3e} (tol {TOL_MODEL}), max_abs_err "
        f"{e['max_abs_err']:.3e}; launches {c}")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"dev-fwd128: error {e} over {TOL_MODEL}")
    del y, dfull, deager
    fc = unet_fwd_check(torch, make_feature_extractor, dplan, dsd, dev,
                        "dev-fwd128")
    for name, r in fc.items():
        two_part_gate(f"dev-fwd128 {name}", r["kernels"], r["plain_bf16"])
    out["fwd128"] = dict(ms=ms, plain_ms=plain_ms, launches=c, check=fc,
                         **e)
    torch.cuda.empty_cache()

    # full_tiled on 256^3: 2x2x2 norm tiles at every level
    tiled_kw = dict(strategy="full_tiled", roi_size=(128, 128, 128))
    dtiled = make_feature_extractor(dplan, dsd, device=dev, **tiled_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    feats_t, t_s = timed(torch, lambda: dtiled(vol256))
    c = paths["dev_full_tiled_256"] = counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_path("dev-full_tiled", feats_t, (1, 256, 256, 256, 32), c,
               dev_needed)
    ref, plain_s = timed(torch, lambda: make_feature_extractor(
        dplan, dsd, device=dev, impl="eager", **tiled_kw)(vol256))
    e = model_err(feats_t, ref)
    del ref
    log(f"[dev-full_tiled] 256^3 tiles (2, 2, 2) -> "
        f"{tuple(feats_t.shape)} in {t_s:.4f} s (plain f32 path "
        f"{plain_s:.4f} s), peak {peak:.2f} GiB; vs plain mean|err|/std "
        f"{e['mean_err_over_std']:.3e} (tol {TOL_MODEL}), max_abs_err "
        f"{e['max_abs_err']:.3e}; launches {c}")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"dev-full_tiled: error {e} over {TOL_MODEL}")
    out["full_tiled_256"] = dict(seconds=t_s, plain_seconds=plain_s,
                                 peak_gib=peak, launches=c, **e)
    del dtiled
    torch.cuda.empty_cache()

    # sliding at the reference settings
    S = DEV_SLIDING_SIZE
    vol = vol256[:, :S, :S, :S].contiguous()
    dslide = make_feature_extractor(dplan, dsd, device=dev, **sw_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    feats_s, s_s = timed(torch, lambda: dslide(vol))
    c = paths[f"dev_sliding_{S}"] = counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_win = len(sw.compute_window_starts((S,) * 3, (128,) * 3, 0.8))
    check_path("dev-sliding", feats_s, (1, S, S, S, 32), c,
               dev_needed + ["blend_scatter"])
    log(f"[dev-sliding] {S}^3, {n_win} windows -> {tuple(feats_s.shape)} "
        f"in {s_s:.4f} s, peak {peak:.2f} GiB, launches {c}")
    out["sliding"] = dict(size=S, seconds=s_s, windows=n_win, peak_gib=peak,
                          launches=c)
    # two feature definitions (per-tile vs per-window statistics), not a
    # kernel check: printed, not gated
    cos = mean_cosine(feats_t[:, :S, :S, :S], feats_s)
    log(f"[dev] mean voxelwise cosine full_tiled vs sliding at {S}^3: "
        f"{cos:.4f}")
    out["cosine_full_tiled_vs_sliding"] = cos
    del feats_t, feats_s
    torch.cuda.empty_cache()
    got = dslide(vol160)
    ref = make_feature_extractor(dplan, dsd, device=dev, impl="eager",
                                 **sw_kw)(vol160)
    e = model_err(got, ref)
    log(f"[dev-sliding] 160^3 (27 windows) vs plain f32 path: "
        f"mean|err|/std {e['mean_err_over_std']:.3e} (tol {TOL_MODEL}), "
        f"max_abs_err {e['max_abs_err']:.3e}")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"dev-sliding: error {e} over {TOL_MODEL}")
    out["sliding"]["check_160"] = e
    return out


def run_vit(torch, dev, make_feature_extractor, wrappers, paths, cfg,
            init_primus_params, Primus, vol256, vol128, vol160, sw_kw, sw):
    """Phase 6: the 26M ViT (registry `anatomix-dev-vit`) at full width and
    depth with seeded weights. Its extractor always slides windows of
    `cfg.input_shape` (128^3), as the JAX package's does, and its windows
    take the stage-wise decoder's fold exit straight into the stitch."""
    vit_needed = ["conv3x3x3_ndhwc", "norm_apply_ndhwc", "conv_down2_ndhwc",
                  "flash_attention", "depth_to_space2_ndhwc",
                  "depth_to_space_fold_ndhwc", "blend_scatter"]
    vsd = {k: v.to(dev) for k, v in init_primus_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    n_params = sum(v.numel() for v in vsd.values())
    out = {"params": n_params}
    log(f"[vit] anatomix-dev-vit: {n_params} parameters, embed "
        f"{cfg.embed_dim}, {cfg.eva_depth} blocks, {cfg.eva_numheads} heads "
        f"of {cfg.head_dim}, N {cfg.num_tokens + cfg.num_register_tokens}")
    C = cfg.num_classes
    kw = {k: v for k, v in sw_kw.items() if k != "roi_size"}

    # one 128^3 window at B=1 through the extractor, by CUDA events
    one = make_feature_extractor(cfg, vsd, device=dev,
                                 **dict(kw, sw_batch_size=1))
    one(vol128)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    y = one(vol128)
    torch.cuda.synchronize()
    c = paths["vit_fwd128"] = counts(wrappers)
    check_path("vit-fwd128", y, (1, 128, 128, 128, C), c, vit_needed)
    ms = cuda_ms(lambda: one(vol128))
    eager = make_feature_extractor(cfg, vsd, device=dev, impl="eager",
                                   **dict(kw, sw_batch_size=1))
    plain_ms = cuda_ms(lambda: eager(vol128))
    # the model's forward alone, without the extractor's set-up (window
    # starts, the importance map made on the host) and stitch
    model = Primus.from_state_dict(cfg, vsd, device=dev)
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(vol128, emit="fold"))
        model_plain_ms = cuda_ms(lambda: model(
            vol128, compute_dtype=torch.float32, plain=True))
    log(f"[vit-fwd128] 26M ViT window 128^3 B=1 through the extractor: "
        f"kernels {ms:.4f} ms, plain f32 path {plain_ms:.4f} ms (model "
        f"forward alone {model_ms:.4f} ms, plain {model_plain_ms:.4f} ms); "
        f"launches {c}")
    out["fwd128"] = dict(ms=ms, plain_ms=plain_ms, model_ms=model_ms,
                         model_plain_ms=model_plain_ms, launches=c)
    # the noisy volume and the smooth field, each one window through the
    # extractor; the plain path in bf16 runs the same route on the model
    smooth128 = smooth_field(torch, dev, 128, seed=3)[None, ..., None]
    for name, vol in (("noisy", vol128), ("smooth", smooth128.contiguous())):
        ref = eager(vol)
        with torch.inference_mode():
            ref_bf16 = model(vol, plain=True, emit="fold").reshape(ref.shape)
        e = model_err(one(vol), ref)
        e_b = mean_rel(ref_bf16, ref)
        log(f"[vit-fwd128] {name} vs plain f32 path: mean|err|/std "
            f"{e['mean_err_over_std']:.3e}, the plain path in bf16 "
            f"{e_b:.3e} (tol {TOL_MODEL} and {TOL_VS_BF16_PLAIN}x plain "
            f"bf16 + {TOL_VS_BF16_PLAIN_ABS}), max_abs_err "
            f"{e['max_abs_err']:.3e}, max/max {e['max_err_over_max']:.3e}")
        two_part_gate(f"vit-fwd128 {name}", e["mean_err_over_std"], e_b)
        out["fwd128"][name] = dict(plain_bf16=e_b, **e)
        del ref, ref_bf16
    del y, one, eager
    torch.cuda.empty_cache()

    # sliding at the reference settings on 256^3 (343 windows, sw_batch 2):
    # the fold route the extractor takes, then the block-space route of the
    # same model (a window function asking for the spatial emit)
    vslide = make_feature_extractor(cfg, vsd, device=dev, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    feats, s_s = timed(torch, lambda: vslide(vol256))
    c = paths["vit_sliding_256"] = counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_win = len(sw.compute_window_starts((256,) * 3, (128,) * 3, 0.8))
    check_path("vit-sliding", feats, (1, 256, 256, 256, C), c, vit_needed)
    log(f"[vit-sliding] 256^3, {n_win} windows, fold route -> "
        f"{tuple(feats.shape)} in {s_s:.4f} s, peak {peak:.2f} GiB, "
        f"launches {c}")
    sw_args = {k: v for k, v in kw.items() if k != "strategy"}
    with torch.inference_mode():
        block, b_s = timed(torch, lambda: sw.sliding_window_inference(
            vol256, lambda w: model(w, emit="spatial"), C,
            roi_size=cfg.input_shape, **sw_args))
    cos = mean_cosine(feats, block)
    log(f"[vit-sliding] 256^3 block-space route (V1 exit, f32 windows): "
        f"{b_s:.4f} s; fold route {s_s:.4f} s; mean voxelwise cosine of the "
        f"two routes {cos:.6f}; {nvidia_smi()}")
    out["sliding"] = dict(size=256, seconds=s_s, windows=n_win,
                          peak_gib=peak, launches=c,
                          block_space_seconds=b_s, cosine_routes=cos)
    del feats, block, model
    torch.cuda.empty_cache()
    got = vslide(vol160)
    ref, plain_s = timed(torch, lambda: make_feature_extractor(
        cfg, vsd, device=dev, impl="eager", **kw)(vol160))
    e = model_err(got, ref)
    log(f"[vit-sliding] 160^3 (27 windows) vs plain f32 path: "
        f"mean|err|/std {e['mean_err_over_std']:.3e} (tol {TOL_MODEL}), "
        f"max_abs_err {e['max_abs_err']:.3e}, max/max "
        f"{e['max_err_over_max']:.3e}; plain {plain_s:.4f} s")
    if not e["mean_err_over_std"] < TOL_MODEL:
        raise RuntimeError(f"vit-sliding: error {e} over {TOL_MODEL}")
    out["sliding"]["check_160"] = dict(plain_seconds=plain_s, **e)
    del got, ref, vslide
    torch.cuda.empty_cache()
    return out


def run_vit1(torch, dev, make_feature_extractor, wrappers, paths, vit_kw,
             init_primus_params, Primus, PrimusConfig, vol128, patch):
    """Phase 6b: the v1 ViT (the patch-embed tokenizer) at the
    `anatomix-dev-vit` widths and depth (embed 396, 12 blocks, 6 heads, 32
    out, demean) with seeded weights, on one 128^3 window. Patch 8: through
    the extractor (the fold route, three decoder stages). Patch 16: the
    model's forward with the spatial emit (four stages, the interleave
    exit). Each held on the noisy volume and the smooth field against the
    f32 plain path and the plain path in bf16."""
    tag = "vit1-fwd128" if patch == 8 else f"vit1p{patch}-fwd128"
    cfg = PrimusConfig(**dict(vit_kw, version="v1",
                              patch_embed_size=(patch,) * 3))
    vsd = {k: v.to(dev) for k, v in init_primus_params(
        cfg, torch.Generator().manual_seed(1)).items()}
    model = Primus.from_state_dict(cfg, vsd, device=dev)
    C = cfg.num_classes
    needed = ["space_to_depth_c1_ndhwc", "space_to_depth2_ndhwc",
              "flash_attention", "depth_to_space2_ndhwc"]
    if patch == 8:
        kw = dict(overlap=0.8, mode="gaussian", sigma_scale=0.25,
                  sw_batch_size=1)
        one = make_feature_extractor(cfg, vsd, device=dev, **kw)
        eager = make_feature_extractor(cfg, vsd, device=dev, impl="eager",
                                       **kw)
        emit = "fold"
        needed += ["depth_to_space_fold_ndhwc", "blend_scatter"]
    else:
        def one(v):
            with torch.inference_mode():
                return model(v)

        def eager(v):
            with torch.inference_mode():
                return model(v, compute_dtype=torch.float32, plain=True)
        emit = "spatial"
        needed += ["depth_to_space_interleave_ndhwc"]
    one(vol128)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    y = one(vol128)
    torch.cuda.synchronize()
    c = paths[tag.replace("-", "_")] = counts(wrappers)
    check_path(tag, y, (1, 128, 128, 128, C), c, needed)
    ms = cuda_ms(lambda: one(vol128))
    plain_ms = cuda_ms(lambda: eager(vol128))
    n_params = sum(v.numel() for v in vsd.values())
    log(f"[{tag}] v1 patch {patch}^3, {n_params} parameters, "
        f"{len(model.decoder)} decoder stages "
        f"{[m.out_channels for m in model.decoder]}, N "
        f"{cfg.num_tokens + cfg.num_register_tokens}: 128^3 B=1 kernels "
        f"{ms:.4f} ms, plain f32 path {plain_ms:.4f} ms; launches {c}")
    out = dict(ms=ms, plain_ms=plain_ms, launches=c, params=n_params)
    smooth128 = smooth_field(torch, dev, 128, seed=3)[None, ..., None]
    for name, vol in (("noisy", vol128), ("smooth", smooth128.contiguous())):
        ref = eager(vol)
        with torch.inference_mode():
            ref_bf16 = model(vol, plain=True, emit=emit).reshape(ref.shape)
        e = model_err(one(vol), ref)
        e_b = mean_rel(ref_bf16, ref)
        log(f"[{tag}] {name} vs plain f32 path: mean|err|/std "
            f"{e['mean_err_over_std']:.3e}, the plain path in bf16 "
            f"{e_b:.3e} (tol {TOL_MODEL} and {TOL_VS_BF16_PLAIN}x plain "
            f"bf16 + {TOL_VS_BF16_PLAIN_ABS}), max_abs_err "
            f"{e['max_abs_err']:.3e}, max/max {e['max_err_over_max']:.3e}")
        two_part_gate(f"{tag} {name}", e["mean_err_over_std"], e_b)
        out[name] = dict(plain_bf16=e_b, **e)
        del ref, ref_bf16
    del y, model, vsd
    torch.cuda.empty_cache()
    return out


def two_part_gate(name, e, e_plain_bf16):
    """The JAX package's bf16 rule (tests/test_tpu_numerics.py:36-64) on
    mean|err|/std against the f32 plain path: under TOL_MODEL, and under
    TOL_VS_BF16_PLAIN times the plain path run in bf16 plus
    TOL_VS_BF16_PLAIN_ABS. Raises if either part fails."""
    limit = TOL_VS_BF16_PLAIN * e_plain_bf16 + TOL_VS_BF16_PLAIN_ABS
    if not (e < TOL_MODEL and e < limit):
        raise RuntimeError(f"{name}: mean|err|/std {e:.4e} vs the f32 plain "
                           f"path, limits {TOL_MODEL} and {limit:.4e} (the "
                           f"plain path in bf16 reads {e_plain_bf16:.4e})")


def mean_rel(got, ref) -> float:
    """mean|err|/std, the JAX package's bf16-vs-f32 model metric."""
    return model_err(got, ref)["mean_err_over_std"]


def unet_fwd_check(torch, make_feature_extractor, plan, sd, dev,
                   tag) -> dict:
    """The UNet's 128^3 B=1 forward (`full`) on the kernels against the f32
    plain path (the eager `Unet` module), on the smooth field and on the
    noisy CT-like volume, beside the plain path run in bf16 (the eager
    module under bf16 autocast: bf16 convs, as JAX's XLA bf16 path)."""
    fused = make_feature_extractor(plan, sd, strategy="full", device=dev)
    eager = make_feature_extractor(plan, sd, strategy="full", impl="eager",
                                   device=dev)
    out = {}
    for name, vol in (
            ("smooth", smooth_field(torch, dev, 128, seed=3)[
                None, ..., None].contiguous()),
            ("noisy", synthetic_volume(torch, dev, 128, seed=4))):
        ref = eager(vol)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            ref_bf16 = eager(vol)
        out[name] = dict(kernels=mean_rel(fused(vol), ref),
                         plain_bf16=mean_rel(ref_bf16, ref))
        log(f"[{tag}] {name} 128^3 vs the f32 plain path, mean|err|/std: "
            f"kernels {out[name]['kernels']:.3e}, the plain path in bf16 "
            f"{out[name]['plain_bf16']:.3e} (tol {TOL_MODEL} and "
            f"{TOL_VS_BF16_PLAIN}x plain bf16 + {TOL_VS_BF16_PLAIN_ABS})")
        del ref, ref_bf16
    del fused, eager
    torch.cuda.empty_cache()
    return out


def p1_bisect(torch, dev) -> dict:
    """Where the bf16 ViT's error on the smooth step batch comes from. The
    ViT step's model (`PretrainConfig(netG="primus")`, seeded) on the smooth
    and the noisy step batch (the two views as batch 2), run three ways: the
    kernels in bf16, the plain path in bf16 and the plain f32 path, with
    every stage's output recorded (`Primus.forward`'s `record`: the
    tokenizer grid, each EVA block's residual stream, the final norm, each
    decoder GEMM, the exit); each stage's mean|err|/std against the f32
    plain path. Then each part on its own: the bf16 kernels from the f32
    path's input to that part, and the f32 plain path from the bf16 path's
    input to it."""
    from anatomix_tpu_torch.models.vit3d import Primus
    from anatomix_tpu_torch.models.vit3d.primus import _KERNELS, _PLAIN
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    bf, f32 = torch.bfloat16, torch.float32
    cfg = PretrainConfig(netG="primus")
    vcfg, _, state0, _ = build_all(cfg, 1000, device=dev)
    model = Primus.from_state_dict(vcfg, state0.params_g, device=dev)
    del state0
    S = cfg.crop_size
    out = {}
    for batch, noisy in (("smooth", False), ("noisy", True)):
        views = train_batch(torch, dev, S, noisy=noisy)[0]
        x = torch.cat([views[:, 0], views[:, 1]], dim=0)
        recs = {}
        with torch.no_grad():
            for mode, kw in (("kernels", dict(compute_dtype=bf)),
                             ("plain_bf16", dict(compute_dtype=bf,
                                                 plain=True)),
                             ("plain_f32", dict(compute_dtype=f32,
                                                plain=True))):
                r = {}
                r["exit"] = model(x, record=lambda n, t, r=r: r.__setitem__(
                    n, t.float()), **kw)
                recs[mode] = r
        ref = recs["plain_f32"]
        stages = {}
        for name in ref:
            stages[name] = dict(kernels=mean_rel(recs["kernels"][name],
                                                 ref[name]),
                                plain_bf16=mean_rel(recs["plain_bf16"][name],
                                                    ref[name]))
            log(f"[p1-bisect] {batch} {name}: mean|err|/std vs the f32 plain "
                f"path: kernels bf16 {stages[name]['kernels']:.3e}, plain "
                f"bf16 {stages[name]['plain_bf16']:.3e}")
        got = recs["kernels"]
        pb, pf = model._pack(bf), model._pack(f32)
        alone = {}
        with torch.no_grad():
            tok = model._embed(ref["tokenizer"])
            for blk in model.blocks:
                tok = model._block(blk, tok, _KERNELS, bf)
            alone["blocks bf16 from f32 tokens"] = mean_rel(
                model._unembed(tok), ref["final norm"])
            alone["decoder bf16 from f32 grid"] = mean_rel(
                model._decoder(ref["final norm"], pb, _KERNELS, bf),
                ref["exit"])
            alone["decoder f32 from bf16 grid"] = mean_rel(
                model._decoder(got["final norm"], pf, _PLAIN, f32),
                ref["exit"])
            tok = model._embed(got["tokenizer"])
            for blk in model.blocks:
                tok = model._block(blk, tok, _PLAIN, f32)
            alone["blocks and decoder f32 from bf16 tokenizer"] = mean_rel(
                model._decoder(model._unembed(tok), pf, _PLAIN, f32),
                ref["exit"])
        for k, v in alone.items():
            log(f"[p1-bisect] {batch} exit, {k}: mean|err|/std {v:.3e}")
        out[batch] = dict(stages=stages, parts=alone)
        del recs, ref, got
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out


def train_batch(torch, dev, S: int, seed: int = 12, noisy: bool = False):
    """A seeded synthetic pretraining batch: two views (1, 2, S^3, 1) of one
    smooth volume (or, `noisy`, the CT-like volume of blobs plus noise) with
    a per-view gain, gamma and shift, and labels (1, S^3, 1) from a smooth
    field quantized to 10 classes."""
    gen = torch.Generator(device=dev).manual_seed(11)
    vol = (synthetic_volume(torch, dev, S, seed)[0, ..., 0] if noisy
           else smooth_field(torch, dev, S, seed=seed))
    gain = 0.8 + 0.4 * torch.rand((2,), generator=gen, device=dev)
    gamma = 0.7 + 0.6 * torch.rand((2,), generator=gen, device=dev)
    shift = 0.1 * torch.randn((2,), generator=gen, device=dev)
    views = torch.stack([gain[k] * vol ** gamma[k] + shift[k]
                         for k in range(2)])[None, ..., None].contiguous()
    segs = (smooth_field(torch, dev, S, seed=13) * 10).long().clamp(
        max=9)[None, ..., None]
    return views, segs


def profile_train(torch, dev, out_dir, netG="unet"):
    """Kernel time by name and the device's busy share over one pretraining
    step at `PretrainConfig(netG=netG)` (`netG="dev"`: the dev UNet's
    `dev_pretrain_config()`), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = (dev_pretrain_config() if netG == "dev"
           else PretrainConfig(netG=netG))
    tag = {"unet": "train_step128", "primus": "vit_train_step128",
           "dev": "dev_train_step128"}[netG]
    _, _, state, step = build_all(cfg, 1000, device=dev)
    views, segs = train_batch(torch, dev, cfg.crop_size)
    sampler = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa
    state, _ = step(state, views, segs, sampler())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, views, segs, sampler())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted(
        ((getattr(ev, attr) / 1e3, ev.count, ev.key) for ev in events
         if is_device_work(ev) and getattr(ev, attr) > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows)
    host = sorted(((ev.cpu_time_total / 1e3, ev.count, ev.key)
                   for ev in events if ev.key.startswith(RANGES)
                   and ev.device_type == DeviceType.CPU), reverse=True)
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(events.table(sort_by=attr, row_limit=60))
    fold = [r for r in rows if "pad_shell" in r[2]]
    fold_ms = sum(r[0] for r in fold)
    log(f"[profile] {tag}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %); reflect fold "
        f"(shell pass) {fold_ms:.3f} ms in {sum(r[1] for r in fold)} "
        f"launches")
    for ms, count, key in rows[:24]:
        log(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    for ms, count, key in host:
        log(f"[profile]   {ms:9.3f} ms host  {count:3d}x  {key}")
    del state
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, fold_ms=fold_ms,
                top=[dict(ms=r[0], count=r[1], name=r[2]) for r in rows[:30]],
                host_ranges=[dict(ms=r[0], count=r[1], name=r[2])
                             for r in host])


def train_dw_check(torch, kt, plan, state0, views, segs, sampler, kw):
    """The first step's loss and gradients from `state0` on one batch, on
    the kernels and beside them: (a) the kernel path, recording each conv
    backward launch with its inputs; (b) the same forward with the conv
    backward on the plain versions (bf16 dx rounded where the kernel
    rounds); (c) the plain f32 path (`F.conv3d`, torch's pool and
    upsample); (d) the plain f32 path on the views rounded to bf16. (a)
    against (b) holds the step's backward on the kernels, inside autograd
    with batch norm, pool, upsample and gather, against the plain backward
    of the same activations; (a) against (c) is the end-to-end dW error,
    and (d) against (c) its floor: how far a bf16-size change of the input
    alone moves the step's dW."""
    from anatomix_tpu_torch.pretraining.train_step import nce_loss_and_grads

    records = []

    def rec(fn, which):
        def call(a, b, *, pad_type):
            out = fn(a, b, pad_type=pad_type)
            records.append((which, (a, b), pad_type, out))
            return out
        return call

    def run(v, **extra):
        return nce_loss_and_grads(plan, state0.params_g, state0.params_f, v,
                                  segs, sampler(), **kw, **extra)

    with kt.backward_route(rec(kt.conv3x3x3_dgrad_ndhwc, "dgrad"),
                           rec(kt.conv3x3x3_wgrad_ndhwc, "wgrad")):
        loss_k, _, grads_k, _ = run(views)
    with kt.backward_route(kt.conv3x3x3_dgrad_ndhwc_plain,
                           kt.conv3x3x3_wgrad_ndhwc_plain):
        loss_b, _, grads_b, _ = run(views)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_p, _, grads_p, _ = run(views, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _, _, grads_q, _ = run(views.to(torch.bfloat16).float(), plain=True)

    def dw_err(grads, ref):
        return {i: float((grads[f"model.{i}.weight"]
                          - ref[f"model.{i}.weight"]).abs().mean()
                         / ref[f"model.{i}.weight"].std())
                for i in plan.conv_indices}

    from anatomix_tpu_torch.models.unet import prelu_key

    pkey = prelu_key(plan)
    prelu = {}
    if pkey:
        # the shared PReLU weight's gradient against the plain backward's
        prelu["prelu_backward"] = float(
            (grads_k[pkey] - grads_b[pkey]).abs().max()
            / grads_b[pkey].abs().max())
    launches = {"wgrad": [], "dgrad": [], "dgrad_shell": []}
    for which, args, pad, got in records:
        plain_fn = (kt.conv3x3x3_wgrad_ndhwc_plain if which == "wgrad"
                    else kt.conv3x3x3_dgrad_ndhwc_plain)
        ref = plain_fn(*args, pad_type=pad)
        launches[which].append(rel_err(got, ref)[1])
        if which == "dgrad":
            launches["dgrad_shell"].append(shell_rel_err(torch, got, ref))
    return dict(
        loss_kernels=float(loss_k), loss_same_forward=float(loss_b),
        loss_plain=float(loss_p), plain_seconds=plain_s,
        dw_backward=dw_err(grads_k, grads_b), dw_end_to_end=dw_err(
            grads_k, grads_p), dw_floor=dw_err(grads_q, grads_p),
        launch_errs=launches, **prelu)


def fmt_dw(errs) -> str:
    worst = max(errs, key=errs.get)
    return f"max {errs[worst]:.3e} at layer {worst}: " + ", ".join(
        f"{i}: {v:.2e}" for i, v in errs.items())


def run_train(torch, dev, wrappers, paths, kt):
    """Phase 7: the 6M pretraining step at `PretrainConfig()` (the reference
    launcher's settings, nothing cut) with seeded weights, on a seeded
    synthetic batch: views from one smooth 128^3 volume with a per-view
    intensity change, labels from a smooth field quantized to 10 classes.
    Five steps on the same batch with the same sampler seed; then the first
    step's loss and every conv's dW against the plain paths
    (`train_dw_check`), on this batch and on two others (another smooth
    volume, and a noisy one) that show what sets the end-to-end floor."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import NCEOptions

    cfg = PretrainConfig()
    # a dataset epoch of 1000 steps: the const_linear rate is constant here
    plan, taps, state0, step = build_all(cfg, 1000, device=dev)
    S = cfg.crop_size
    views, segs = train_batch(torch, dev, S)
    n_labels = int(segs.unique().numel())
    n_conv = len(plan.conv_indices)
    n_resize = sum(spec.kind in ("pool", "upsample") for spec in plan.layers)
    log(f"[train-step128] PretrainConfig(): ngf {cfg.ngf}, num_downs "
        f"{cfg.num_downs}, crop {S}^3 x batch {cfg.batch_size} (2 views), "
        f"taps {taps} ({plan.tap_channels(taps)} ch), {cfg.num_patches} "
        f"patches, netF {cfg.netF_nc}x{cfg.n_mlps}, {n_conv} convs, "
        f"{sum(v.numel() for v in state0.params_g.values())} G parameters, "
        f"{n_labels} labels")
    sampler = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa

    state = state0
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(5):
        if i == 0:
            reset_counts(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, views, segs, sampler())
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            c = paths["train"] = counts(wrappers)
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med_ms = statistics.median(step_ms[1:])
    log(f"[train-step128] losses {losses}; step ms {step_ms} (median of "
        f"steps 2-5 {med_ms:.4f} ms); peak {peak:.2f} GiB; launches per "
        f"step {c}; {nvidia_smi()}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise RuntimeError(f"train-step128: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train-step128: loss did not fall {losses}")
    # every conv forward and weight gradient, every dx but the entry
    # conv's (each reflect dx a split store and a shell pass); each pool and
    # upsample permutes forward and backward
    want = {"conv3x3x3_ndhwc": n_conv, "conv3x3x3_wgrad_ndhwc": n_conv,
            "conv3x3x3_dgrad_ndhwc": n_conv - 1,
            "pad_shell_ndhwc": n_conv - 1,
            "space_to_depth2_ndhwc": n_resize,
            "depth_to_space2_ndhwc": n_resize}
    if any(c[k] != v for k, v in want.items()):
        raise RuntimeError(f"train-step128: launches {c}, want {want}")
    del state

    # the first step against the plain paths, from the same state and
    # sampler seed; these launches are not the path's
    kw = dict(tap_layers=taps, num_patches=cfg.num_patches,
              nce=NCEOptions(temperature=cfg.nce_T))
    main = train_dw_check(torch, kt, plan, state0, views, segs, sampler, kw)
    loss_rel = abs(losses[0] - main["loss_plain"]) / abs(main["loss_plain"])
    errs = main["launch_errs"]
    log(f"[train-step128] first loss {losses[0]:.6f} (nce_forward on the "
        f"kernels {main['loss_kernels']!r}, with the plain conv backward "
        f"{main['loss_same_forward']!r}) vs plain f32 path "
        f"{main['loss_plain']:.6f}: rel {loss_rel:.3e} (tol "
        f"{TOL_TRAIN_LOSS}); plain loss+grads {main['plain_seconds']:.4f} s")
    log(f"[train-step128] this step's {len(errs['wgrad'])} wgrad and "
        f"{len(errs['dgrad'])} dgrad launches vs their plain versions on the "
        f"same tensors: max rel {max(errs['wgrad']):.3e} (tol {TOL_WGRAD}), "
        f"{max(errs['dgrad']):.3e} (tol {TOL_CONV_BF16}); dgrad on the "
        f"reflect shell alone {max(errs['dgrad_shell']):.3e} (tol "
        f"{TOL_CONV_BF16})")
    log(f"[train-step128] dW mean|err|/std, the step's backward on the "
        f"kernels vs the plain conv backward from the same forward (tol "
        f"{TOL_TRAIN_DW}): {fmt_dw(main['dw_backward'])}")
    log(f"[train-step128] dW mean|err|/std end to end, the kernel path vs "
        f"the plain f32 path: {fmt_dw(main['dw_end_to_end'])}")
    log(f"[train-step128] the plain f32 path on bf16-rounded views vs "
        f"itself: {fmt_dw(main['dw_floor'])}")
    if not loss_rel < TOL_TRAIN_LOSS:
        raise RuntimeError(f"train-step128: loss {losses[0]} vs "
                           f"{main['loss_plain']}")
    if (len(errs["wgrad"]), len(errs["dgrad"])) != (n_conv, n_conv - 1):
        raise RuntimeError(f"train-step128: recorded {errs}")
    if not (max(errs["wgrad"]) < TOL_WGRAD
            and max(errs["dgrad"]) < TOL_CONV_BF16
            and max(errs["dgrad_shell"]) < TOL_CONV_BF16):
        raise RuntimeError(f"train-step128: kernel errors {errs}")
    if not max(main["dw_backward"].values()) < TOL_TRAIN_DW:
        raise RuntimeError(f"train-step128: backward dW {main['dw_backward']}"
                           f" over {TOL_TRAIN_DW}")
    # what sets the end-to-end floor: another smooth volume, and a noisy one
    # (blobs plus noise: fewer near-ties in the pools' windows)
    others = {}
    for tag, (v, sg) in {
        "smooth_seed21": train_batch(torch, dev, S, seed=21),
        "noisy": train_batch(torch, dev, S, noisy=True),
    }.items():
        others[tag] = r = train_dw_check(torch, kt, plan, state0, v, sg,
                                         sampler, kw)
        log(f"[train-step128] {tag}: backward {fmt_dw(r['dw_backward'])}")
        log(f"[train-step128] {tag}: end to end {fmt_dw(r['dw_end_to_end'])}")
        log(f"[train-step128] {tag}: floor {fmt_dw(r['dw_floor'])}")
        if not max(r["dw_backward"].values()) < TOL_TRAIN_DW:
            raise RuntimeError(f"train-step128 {tag}: backward dW "
                               f"{r['dw_backward']} over {TOL_TRAIN_DW}")
    del state0
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, median_step_ms=med_ms,
                peak_gib=peak, launches_per_step=c, loss_rel=loss_rel,
                labels=n_labels, first_step=main, other_batches=others)


# the dev pretraining step: the 94M `anatomix-dev` UNet's options with the
# 6M default's tap roles (the last encoder conv before the bottleneck, the
# bottleneck's first conv, the first conv of three decoder levels, the
# output conv) on the dev plan
DEV_TAPS = (34, 38, 45, 52, 59, 79)


def dev_pretrain_config():
    """`PretrainConfig` at the `anatomix-dev` UNet's published options
    (registry: ngf 32, num_downs 5, output 32, instance norm eps 1e-2, Avg
    pool, trilinear), the launcher's other defaults (crop 128, 512
    patches, netF 256x3, AdamW 2e-4)."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig

    return PretrainConfig(ngf=32, num_downs=5, output_nc=32,
                          normG="instance", norm_eps_G=1e-2,
                          pool_type="Avg", interp_type="trilinear",
                          nce_layers=DEV_TAPS)


def dev_backward_checks(kt, torch, F, dev, gen) -> dict:
    """T-w, T-x and the reflect shell pass at the dev step's widths (crop
    128, the two views as batch 2): the entry conv (wgrad only), the
    full-resolution conv and its decoder concat, the 8^3 level and the
    first decoder conv after the concat (1536 -> 512, whose dgrad writes
    1536 channels), the 4^3 bottleneck (512 -> 1024, 1024 -> 1024); the
    shell at 4^3, where it holds most of the volume, and at 8^3."""
    rows = {"conv3x3x3_wgrad_ndhwc": [], "conv3x3x3_dgrad_ndhwc": [],
            "pad_shell_ndhwc": []}
    for B, S, ci, co in [(2, 128, 1, 32), (2, 128, 32, 32), (2, 128, 96, 32),
                         (2, 8, 512, 512), (2, 8, 1536, 512),
                         (2, 4, 512, 1024), (2, 4, 1024, 1024)]:
        for which in ("wgrad", "dgrad"):
            if which == "dgrad" and ci == 1:
                continue
            rows[f"conv3x3x3_{which}_ndhwc"].append(check_conv_backward(
                kt, torch, F, dev, gen, B, S, ci, co, which))
    for B, S, C in [(2, 4, 512), (2, 4, 1024), (2, 8, 1536)]:
        rows["pad_shell_ndhwc"].append(
            check_reflect_shell(kt, torch, dev, gen, B, S, C))
    return rows


def log_kernel_rows(checks) -> list[str]:
    """Print each kernel row; the names of the rows that failed."""
    failed = []
    for name, rows in checks.items():
        for row in rows:
            log(f"[kernel] {name} {row['shape']}: max_abs_err "
                f"{row['max_abs_err']:.3e} rel {row['rel_err']:.3e} "
                f"(tol {row['tol']:g}) ms {row['ms']:.4f} plain_ms "
                f"{row['plain_ms']:.4f} library_ms {row['library_ms']} "
                f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})"
                + (f"; plan: {row['plan']}" if "plan" in row else "")
                + (f"; reflect split: conv {row['conv_ms']:.4f} + fold "
                   f"{row['fold_ms']:.4f} ms (fold library_ms "
                   f"{row['fold_library_ms']:.4f}), shell-only rel "
                   f"{row['shell_rel_err']:.3e}, two launches max|diff| "
                   f"{row['repeat_max_abs_diff']}" if "conv_ms" in row
                   else ""))
            if not row["ok"]:
                failed.append(f"{name} {row['shape']}")
    return failed


def dev_forward_check(torch, dev, plan, params, batches) -> dict:
    """The dev train walk's output volume (no grad) on the kernels (the
    convs on the three-term split) and the plain walk run in bf16 (bf16
    convs under autocast, f32 norms), each against the f32 plain walk, on
    each batch ((1, 2, S^3, 1) views, run as batch 2)."""
    from anatomix_tpu_torch.models.unet_train import unet_apply_train

    out = {}
    with torch.no_grad():
        for name, views in batches.items():
            x = torch.cat([views[:, 0], views[:, 1]], dim=0)
            ref = unet_apply_train(plan, params, x, plain=True)[0]
            got = unet_apply_train(plan, params, x)[0]
            with torch.autocast("cuda", dtype=torch.bfloat16):
                ref_b = unet_apply_train(plan, params, x, plain=True)[0]
            out[name] = dict(kernels=model_err(got, ref),
                             plain_bf16=model_err(ref_b, ref))
            del ref, got, ref_b
    torch.cuda.empty_cache()
    return out


def run_dev_train(torch, dev, wrappers, paths, kt):
    """`[dev-train-step128]`: the 94M dev UNet's pretraining step at
    `dev_pretrain_config()` (full width and depth, crop 128^3, the two
    views as batch 2, 512 patches, netF 256x3, AdamW 2e-4) with seeded
    weights on `[train-step128]`'s seeded batch: five steps through
    `build_all` -> `step` (the general train walk: K1 on the three-term
    split, T-x with the reflect shell pass, T-w);
    `dev_pretrain_step_seconds_128crop` the median CUDA-event time of steps
    2-5, the peak memory of the first step; then the first step's loss and
    every conv's dW against the plain paths (`train_dw_check`), every
    dgrad and wgrad launch against its plain version on the step's own
    tensors, and the output volume on a smooth and a noisy batch to the
    two-part rule."""
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import NCEOptions

    cfg = dev_pretrain_config()
    plan, taps, state0, step = build_all(cfg, 1000, device=dev)
    S = cfg.crop_size
    views, segs = train_batch(torch, dev, S)
    n_conv = len(plan.conv_indices)
    log(f"[dev-train-step128] anatomix-dev options: ngf {cfg.ngf}, "
        f"num_downs {cfg.num_downs}, {cfg.normG} eps {cfg.norm_eps_G}, "
        f"{cfg.pool_type} pool, {cfg.interp_type}; crop {S}^3 x batch "
        f"{cfg.batch_size} (2 views), taps {taps} "
        f"({plan.tap_channels(taps)} ch), {cfg.num_patches} patches, netF "
        f"{cfg.netF_nc}x{cfg.n_mlps}, {n_conv} convs, "
        f"{sum(v.numel() for v in state0.params_g.values())} G parameters")
    sampler = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa

    state = state0
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(5):
        if i == 0:
            reset_counts(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, views, segs, sampler())
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            c = paths["dev_train"] = counts(wrappers)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    med_ms = statistics.median(step_ms[1:])
    log(f"[dev-train-step128] losses {losses}; step ms {step_ms}; "
        f"dev_pretrain_step_seconds_128crop {med_ms / 1e3:.6f} (median of "
        f"steps 2-5, CUDA events); peak {peak:.2f} GiB (the first step); "
        f"launches per step {c}; {nvidia_smi()}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise RuntimeError(f"dev-train-step128: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"dev-train-step128: loss did not fall {losses}")
    # every conv forward (on the split) and weight gradient, every dx but
    # the entry conv's (a split store and a shell pass each); pools and
    # upsamples are torch glue on the spatial grid
    want = {k: 0 for k in wrappers}
    want.update({"conv3x3x3_ndhwc": n_conv, "conv3x3x3_wgrad_ndhwc": n_conv,
                 "conv3x3x3_dgrad_ndhwc": n_conv - 1,
                 "pad_shell_ndhwc": n_conv - 1})
    if c != want:
        raise RuntimeError(f"dev-train-step128: launches {c}, want {want}")
    del state

    kw = dict(tap_layers=taps, num_patches=cfg.num_patches,
              nce=NCEOptions(temperature=cfg.nce_T))
    main = train_dw_check(torch, kt, plan, state0, views, segs, sampler, kw)
    loss_rel = abs(losses[0] - main["loss_plain"]) / abs(main["loss_plain"])
    errs = main["launch_errs"]
    log(f"[dev-train-step128] first loss {losses[0]:.6f} (nce_forward on the "
        f"kernels {main['loss_kernels']!r}, with the plain conv backward "
        f"{main['loss_same_forward']!r}) vs plain f32 path "
        f"{main['loss_plain']:.6f}: rel {loss_rel:.3e} (tol "
        f"{TOL_TRAIN_LOSS}); plain loss+grads {main['plain_seconds']:.4f} s")
    log(f"[dev-train-step128] this step's {len(errs['wgrad'])} wgrad and "
        f"{len(errs['dgrad'])} dgrad launches vs their plain versions on the "
        f"same tensors: max rel {max(errs['wgrad']):.3e} (tol {TOL_WGRAD}), "
        f"{max(errs['dgrad']):.3e} (tol {TOL_CONV_BF16}); dgrad on the "
        f"reflect shell alone {max(errs['dgrad_shell']):.3e} (tol "
        f"{TOL_CONV_BF16})")
    log(f"[dev-train-step128] dW mean|err|/std, the step's backward on the "
        f"kernels vs the plain conv backward from the same forward (tol "
        f"{TOL_TRAIN_DW}): {fmt_dw(main['dw_backward'])}")
    log(f"[dev-train-step128] dW mean|err|/std end to end, the kernel path "
        f"vs the plain f32 path: {fmt_dw(main['dw_end_to_end'])}")
    log(f"[dev-train-step128] the plain f32 path on bf16-rounded views vs "
        f"itself: {fmt_dw(main['dw_floor'])}")
    if not loss_rel < TOL_TRAIN_LOSS:
        raise RuntimeError(f"dev-train-step128: loss {losses[0]} vs "
                           f"{main['loss_plain']}")
    if (len(errs["wgrad"]), len(errs["dgrad"])) != (n_conv, n_conv - 1):
        raise RuntimeError(f"dev-train-step128: recorded {errs}")
    if not (max(errs["wgrad"]) < TOL_WGRAD
            and max(errs["dgrad"]) < TOL_CONV_BF16
            and max(errs["dgrad_shell"]) < TOL_CONV_BF16):
        raise RuntimeError(f"dev-train-step128: kernel errors {errs}")
    if not max(main["dw_backward"].values()) < TOL_TRAIN_DW:
        raise RuntimeError(f"dev-train-step128: backward dW "
                           f"{main['dw_backward']} over {TOL_TRAIN_DW}")
    # the output volume on the step's smooth batch and on the noisy one
    fwd = dev_forward_check(torch, dev, plan, state0.params_g, {
        "smooth": views, "noisy": train_batch(torch, dev, S, noisy=True)[0]})
    log("[dev-train-step128] output volume vs the f32 plain walk, mean"
        "|err|/std (max/max): " + "; ".join(
            f"{b} kernels {r['kernels']['mean_err_over_std']:.3e} "
            f"({r['kernels']['max_err_over_max']:.3e}), plain walk in bf16 "
            f"{r['plain_bf16']['mean_err_over_std']:.3e}"
            for b, r in fwd.items())
        + f" (tol {TOL_MODEL} and {TOL_VS_BF16_PLAIN}x the plain walk in "
        f"bf16 + {TOL_VS_BF16_PLAIN_ABS})")
    for b, r in fwd.items():
        two_part_gate(f"dev-train-step128 output, {b} batch",
                      r["kernels"]["mean_err_over_std"],
                      r["plain_bf16"]["mean_err_over_std"])
    del state0
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, median_step_ms=med_ms,
                dev_pretrain_step_seconds_128crop=med_ms / 1e3,
                peak_gib=peak, launches_per_step=c, loss_rel=loss_rel,
                first_step=main, forward=fwd)


def attention_grad_check(torch, ka, cfg, state0, views, segs, sampler, kw):
    """The first step's loss and attention gradients from `state0`, on the
    kernels and beside them: (a) the kernel path, recording each dkv and dq
    launch with its plain version on the same tensors; (b) the same forward
    with the attention backward on the plain versions, recording their
    outputs; (c) the plain f32 path. Each attention's (dk, dv) and dq of
    (a) against (b): the step's whole backward on the kernels against the
    plain attention backward from the same forward."""
    from anatomix_tpu_torch.pretraining.train_step import nce_loss_and_grads

    launches = {"dkv": [], "dq": []}
    outs_k, outs_p = [], []

    def rec(fn, plain, which):
        def call(*args):
            got = fn(*args)
            ref = plain(*args)
            got_t = got if isinstance(got, tuple) else (got,)
            ref_t = ref if isinstance(ref, tuple) else (ref,)
            launches[which].append(max(rel_err(a, r)[1]
                                       for a, r in zip(got_t, ref_t)))
            outs_k.append(got_t)
            return got
        return call

    def keep(fn):
        def call(*args):
            got = fn(*args)
            outs_p.append(got if isinstance(got, tuple) else (got,))
            return got
        return call

    def run(**extra):
        return nce_loss_and_grads(cfg, state0.params_g, state0.params_f,
                                  views, segs, sampler(), **kw, **extra)

    with ka.backward_route(
            rec(ka.flash_attention_bwd_dkv, ka.flash_attention_bwd_dkv_plain,
                "dkv"),
            rec(ka.flash_attention_bwd_dq, ka.flash_attention_bwd_dq_plain,
                "dq")):
        loss_k, _, _, _ = run()
    with ka.backward_route(keep(ka.flash_attention_bwd_dkv_plain),
                           keep(ka.flash_attention_bwd_dq_plain)):
        loss_b, _, _, _ = run()
    # outs_*: per block, in backward order, (dk, dv) then (dq,)
    grads = []
    for i in range(0, len(outs_k), 2):
        (dk, dv), (dq,) = outs_k[i], outs_k[i + 1]
        (rk, rv), (rq,) = outs_p[i], outs_p[i + 1]
        grads.append({
            n: float((a - r).abs().mean() / r.std())
            for n, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))})
    del outs_k, outs_p
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_p, _, _, _ = run(plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    return dict(loss_kernels=float(loss_k), loss_same_forward=float(loss_b),
                loss_plain=float(loss_p), plain_seconds=plain_s,
                launch_errs=launches, attention_grads=grads)


def forward_check(torch, dev, vcfg, params, Primus, primus_train_apply,
                  smooth, noisy) -> dict:
    """The train walk's output volume (kernels, no grad), the inference
    path's and the inference model's plain path run in bf16 against their
    plain f32 paths, and the two plain paths against each other, on the
    smooth and the noisy batch ((1, 2, S^3, 1) views, run as batch 2)."""
    model = Primus.from_state_dict(vcfg, params, device=dev)
    out = {}
    with torch.no_grad():
        for name, views in (("smooth", smooth), ("noisy", noisy)):
            x = torch.cat([views[:, 0], views[:, 1]], dim=0)
            ref = primus_train_apply(vcfg, params, x, plain=True)
            out[f"step_{name}"] = model_err(
                primus_train_apply(vcfg, params, x), ref)
            inf_ref = model(x, compute_dtype=torch.float32, plain=True)
            out[f"inference_{name}"] = model_err(model(x), inf_ref)
            out[f"plain_bf16_{name}"] = model_err(model(x, plain=True),
                                                  inf_ref)
            out[f"plain_paths_{name}"] = model_err(inf_ref, ref)
            del ref, inf_ref
    del model
    torch.cuda.empty_cache()
    return out


def vit_step_floor(cfg, B: int) -> dict:
    """The ViT pretraining step's work, in FLOP, from its shapes: the
    forward (tokenizer convs, linears, attention, decoder GEMMs) and the
    backward (dx and dW of every conv but the stem's dx, twice each linear
    and decoder GEMM, 8 + 6 B H N^2 hd for the dkv and dq passes), and the
    least time at 989 TFLOP/s bf16 with the linears at 67 TFLOP/s f32 (the
    precision split of the port and of the JAX package)."""
    S = cfg.input_shape[0]
    ch, s = cfg.tokenizer_base_features, S
    convs = [2 * S ** 3 * 27 * cfg.input_channels * ch]
    for depth in cfg.tokenizer_depth_per_level:
        out, s = min(ch * 2, cfg.embed_dim), s // 2
        convs.append(2 * s ** 3 * 27 * ch * out)
        convs += [2 * s ** 3 * 27 * out * out] * (2 * depth)
        ch = out
    E, N, H, hd = (cfg.embed_dim, cfg.num_tokens + cfg.num_register_tokens,
                   cfg.eva_numheads, cfg.head_dim)
    proj = 2 * cfg.num_tokens * ch * E
    lin = cfg.eva_depth * 2 * N * (4 * E * E + 3 * E * cfg.mlp_hidden)
    attn_f = cfg.eva_depth * 4 * H * N * N * hd
    attn_b = cfg.eva_depth * 14 * H * N * N * hd
    dec, ci, vox = 0, E, cfg.num_tokens
    for i in range(3):
        co = cfg.num_classes if i == 2 else max(ci // 2, 32)
        dec += 2 * vox * ci * 8 * co
        ci, vox = co, vox * 8
    bf16 = B * (3 * sum(convs) - convs[0] + 3 * (proj + dec) + attn_f
                + attn_b)
    f32 = B * 3 * lin
    return dict(flop_bf16=bf16, flop_f32_linears=f32,
                floor_ms=bf16 / PEAK_BF16_FLOPS * 1e3
                + f32 / PEAK_F32_FLOPS * 1e3)


def run_vit_train(torch, dev, wrappers, paths, ka):
    """Phase 8: the 26M ViT's pretraining step at
    `PretrainConfig(netG="primus")` (the JAX package's primus branch: the
    anatomix-dev-vit widths at crop 128^3, demean, qk_norm, inner norm,
    LayerScale 0.1, output_nc 16 channels, one tap; nothing cut) with
    seeded weights on the 6M phase's synthetic batch: five steps; then the
    first step's loss and attention gradients against the plain paths
    (`attention_grad_check`), and the output volume against the plain f32
    path (`forward_check`)."""
    from anatomix_tpu_torch.models.vit3d import Primus
    from anatomix_tpu_torch.models.vit3d.primus_train import (
        primus_train_apply,
    )
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import NCEOptions

    cfg = PretrainConfig(netG="primus")
    vcfg, taps, state0, step = build_all(cfg, 1000, device=dev)
    S = cfg.crop_size
    views, segs = train_batch(torch, dev, S)
    n_g = sum(v.numel() for v in state0.params_g.values())
    log(f"[vit-train-step128] PretrainConfig(netG='primus'): embed "
        f"{vcfg.embed_dim}, {vcfg.eva_depth} blocks, {vcfg.eva_numheads} "
        f"heads of {vcfg.head_dim}, N "
        f"{vcfg.num_tokens + vcfg.num_register_tokens}, crop {S}^3 x batch {cfg.batch_size} (2 views), out "
        f"{vcfg.num_classes} ch, {cfg.num_patches} patches, netF "
        f"{cfg.netF_nc}x{cfg.n_mlps}, {n_g} G parameters, "
        f"{len(state0.params_g)} G leaves")
    sampler = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa
    state = state0
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the stride-2 convs' backward reads dy on its own grid: count the
    # zero-inserted gradients the first step builds (none)
    from anatomix_tpu_torch.kernels import conv_down as kd

    zero_insert, inserted = kd.zero_insert, []

    def counted_zero_insert(*args, **kwargs):
        inserted.append(1)
        return zero_insert(*args, **kwargs)

    for i in range(5):
        if i == 0:
            reset_counts(wrappers)
            kd.zero_insert = counted_zero_insert
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, views, segs, sampler())
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            c = paths["vit_train"] = counts(wrappers)
            kd.zero_insert = zero_insert
            log(f"[vit-train-step128] zero-inserted gradients built by the "
                f"first step: {len(inserted)}")
            if inserted:
                raise RuntimeError("vit-train-step128: the stride-2 backward "
                                   "built a zero-inserted gradient")
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med_ms = statistics.median(step_ms[1:])
    floor = vit_step_floor(vcfg, 2 * cfg.batch_size)
    log(f"[vit-train-step128] losses {losses}; step ms {step_ms} (median of "
        f"steps 2-5 {med_ms:.4f} ms); work {floor['flop_bf16']:.4e} FLOP "
        f"bf16 + {floor['flop_f32_linears']:.4e} f32, floor "
        f"{floor['floor_ms']:.4f} ms; peak {peak:.2f} GiB; launches per "
        f"step {c}; {nvidia_smi()}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise RuntimeError(f"vit-train-step128: non-finite loss {losses}")
    n_stages = len(vcfg.tokenizer_depth_per_level)
    n_conv = 1 + 2 * sum(vcfg.tokenizer_depth_per_level)
    depth = vcfg.eva_depth
    # K1 for the stride-1 convs; T-w for every conv, T-x for every conv but
    # the stem (its input is the data; zero padding, so no shell pass); V2
    # for the stride-2 convs; V3, dkv and dq once per block; V1 once
    want = {"conv3x3x3_ndhwc": n_conv,
            "conv3x3x3_wgrad_ndhwc": n_conv + n_stages,
            "conv3x3x3_dgrad_ndhwc": n_conv - 1 + n_stages,
            "conv_down2_ndhwc": n_stages, "flash_attention": depth,
            "pad_shell_ndhwc": 0,
            "flash_attention_bwd_dkv": depth, "flash_attention_bwd_dq": depth,
            "depth_to_space8_ndhwc": 1}
    if any(c[k] != v for k, v in want.items()):
        raise RuntimeError(f"vit-train-step128: launches {c}, want {want}")
    del state

    # the first step against the plain paths, from the same state and
    # sampler seed; these launches are not the path's
    kw = dict(tap_layers=taps, num_patches=cfg.num_patches,
              nce=NCEOptions(temperature=cfg.nce_T))
    chk = attention_grad_check(torch, ka, vcfg, state0, views, segs, sampler,
                               kw)
    loss_rel = abs(losses[0] - chk["loss_plain"]) / abs(chk["loss_plain"])
    errs = chk["launch_errs"]
    worst = {n: max(g[n] for g in chk["attention_grads"])
             for n in ("dq", "dk", "dv")}
    log(f"[vit-train-step128] first loss {losses[0]:.6f} (nce_forward on the "
        f"kernels {chk['loss_kernels']!r}, with the plain attention backward "
        f"{chk['loss_same_forward']!r}) vs plain f32 path "
        f"{chk['loss_plain']:.6f}: rel {loss_rel:.3e} (tol "
        f"{TOL_TRAIN_LOSS}); plain loss+grads {chk['plain_seconds']:.4f} s")
    log(f"[vit-train-step128] this step's {len(errs['dkv'])} dkv and "
        f"{len(errs['dq'])} dq launches vs their plain versions on the same "
        f"tensors: max rel {max(errs['dkv']):.3e}, {max(errs['dq']):.3e} "
        f"(tol {TOL_CONV_BF16})")
    log(f"[vit-train-step128] each attention's gradients, the step's "
        f"backward on the kernels vs the plain attention backward from the "
        f"same forward, mean|err|/std (tol {TOL_TRAIN_DATTN}): worst "
        f"{worst}; by block (last first) " + ", ".join(
            f"{g['dq']:.2e}/{g['dk']:.2e}/{g['dv']:.2e}"
            for g in chk["attention_grads"]))
    if not loss_rel < TOL_TRAIN_LOSS:
        raise RuntimeError(f"vit-train-step128: loss {losses[0]} vs "
                           f"{chk['loss_plain']}")
    if (len(errs["dkv"]), len(errs["dq"])) != (depth, depth):
        raise RuntimeError(f"vit-train-step128: recorded {errs}")
    if not (max(errs["dkv"]) < TOL_CONV_BF16
            and max(errs["dq"]) < TOL_CONV_BF16):
        raise RuntimeError(f"vit-train-step128: kernel errors {errs}")
    if not max(worst.values()) < TOL_TRAIN_DATTN:
        raise RuntimeError(f"vit-train-step128: attention gradients "
                           f"{chk['attention_grads']} over {TOL_TRAIN_DATTN}")
    # the step's forward output volume (the tap) against the plain f32
    # path, beside the inference path (`Primus.forward`, the same kernels
    # and precision split) against its own plain path, on this smooth batch
    # and on the noisy CT-like one; the two plain paths compute one function
    fwd = forward_check(torch, dev, vcfg, state0.params_g, Primus,
                        primus_train_apply, views,
                        train_batch(torch, dev, S, noisy=True)[0])
    log("[vit-train-step128] output volume vs the plain f32 path, mean"
        "|err|/std (max/max): " + "; ".join(
            f"{k}: {v['mean_err_over_std']:.3e} "
            f"({v['max_err_over_max']:.3e})" for k, v in fwd.items())
        + f" (tol on each batch: the step and the inference path under "
        f"{TOL_MODEL} and {TOL_VS_BF16_PLAIN}x the plain path in bf16 + "
        f"{TOL_VS_BF16_PLAIN_ABS}, the step within {TOL_TRAIN_VS_INFER}x "
        f"the inference path, plain paths {TOL_CONV_F32})")
    for batch in ("smooth", "noisy"):
        e = fwd[f"step_{batch}"]["mean_err_over_std"]
        e_inf = fwd[f"inference_{batch}"]["mean_err_over_std"]
        e_b = fwd[f"plain_bf16_{batch}"]["mean_err_over_std"]
        two_part_gate(f"vit-train-step128 step, {batch} batch", e, e_b)
        two_part_gate(f"vit-train-step128 inference, {batch} batch", e_inf,
                      e_b)
        if not e <= TOL_TRAIN_VS_INFER * e_inf:
            raise RuntimeError(f"vit-train-step128: the step's output on the "
                               f"{batch} batch {e} vs the inference path's "
                               f"{e_inf}")
        if not fwd[f"plain_paths_{batch}"]["mean_err_over_std"] < \
                TOL_CONV_F32:
            raise RuntimeError(f"vit-train-step128: plain paths differ "
                               f"{fwd}")
    del state0
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, median_step_ms=med_ms,
                peak_gib=peak, launches_per_step=c, loss_rel=loss_rel,
                floor=floor, first_step=chk, forward=fwd)

# -----------------------------------------------------------------------------
# the trainer loop

LOOP_SIZE = 160  # the loop's volumes, larger than the 128^3 crop


def loop_data(torch, dev):
    """The loop's seeded subjects as mappings of subject -> {"img" (2, S^3)
    f32, "seg" (S^3) uint8}, S = LOOP_SIZE: three to train on, one to
    validate. Timepoint 0 is the CT-like volume (blobs plus noise), 1 the
    same anatomy under a gamma and a gain; the labels a smooth field
    quantized to 10 classes."""
    def subject(i):
        vol = synthetic_volume(torch, dev, LOOP_SIZE, seed=30 + i)[0, ..., 0]
        img = torch.stack([vol, 0.9 * vol ** 1.3 + 0.05])
        seg = (smooth_field(torch, dev, LOOP_SIZE, seed=50 + i) * 10).clamp(
            max=9).to(torch.uint8)
        return {"img": img.cpu().numpy(), "seg": seg.cpu().numpy()}

    return ({f"{i:06d}": subject(i) for i in range(3)},
            {"000100": subject(3)})


def counted_steps(train_mod, wrappers, per_step, hook=None):
    """Patch `train_mod.build_all` so that each loop step records its
    launches (the counts' change across the call), the step counter it
    started from and its host time; `hook()` runs after each step.
    Returns the function that undoes the patch."""
    build_all = train_mod.build_all

    def patched(*args, **kwargs):
        plan, taps, state, step = build_all(*args, **kwargs)

        def step_counted(state, *a):
            before = counts(wrappers)
            t0 = time.perf_counter()
            out = step(state, *a)
            per_step.append(dict(start=state.step, launches={
                k: v - before[k] for k, v in counts(wrappers).items()},
                enqueue_s=time.perf_counter() - t0))
            if hook is not None:
                hook()
            return out

        return plan, taps, state, step_counted

    train_mod.build_all = patched
    return lambda: setattr(train_mod, "build_all", build_all)


def loop_scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "loss/loss" in r]
    val = [r["loss/val"] for r in recs if "loss/val" in r]
    return steps, val


def check_loop(name, per_step, steps, want_launches, first, last):
    """Fail on a non-finite loss, a step range other than (first, last] or
    a step whose launches differ from the single-step phase's."""
    losses = [r["loss/loss"] for r in steps]
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise RuntimeError(f"{name}: non-finite loss {losses}")
    if [r["step"] for r in steps] != list(range(first + 1, last + 1)) or \
            per_step[0]["start"] != first or len(per_step) != last - first:
        raise RuntimeError(f"{name}: ran steps {[r['step'] for r in steps]} "
                           f"from {per_step[0]['start']}, want {first} -> "
                           f"{last}")
    bad = [i for i, s in enumerate(per_step) if s["launches"] !=
           want_launches]
    if bad:
        raise RuntimeError(f"{name}: launches of step {bad[0] + first + 1} "
                           f"{per_step[bad[0]]['launches']}, want "
                           f"{want_launches}")


def log_loop(name, per_step, steps):
    for s, r in zip(per_step, steps):
        dev_ms = r.get("time/step_device_ms", float("nan"))
        log(f"[{name}] step {r['step']}: loss {r['loss/loss']:.6f}, data "
            f"{r['time/data']:.4f} s, step {r['time/step']:.4f} s (host, "
            f"enqueue {s['enqueue_s']:.4f}), device {dev_ms:.4f} ms (CUDA "
            f"events)")


def loop_summary(per_step, steps) -> dict:
    later = steps[1:]  # the first step of a run carries its set-up
    return dict(
        losses=[r["loss/loss"] for r in steps],
        step_s=[r["time/step"] for r in steps],
        data_s=[r["time/data"] for r in steps],
        device_ms=[r.get("time/step_device_ms") for r in steps],
        median_step_ms=1e3 * statistics.median(r["time/step"] for r in later),
        median_data_ms=1e3 * statistics.median(r["time/data"] for r in later),
        median_device_ms=statistics.median(
            r.get("time/step_device_ms", float("nan")) for r in later),
        launches_per_step=per_step[0]["launches"])


def run_train_loop(torch, dev, wrappers, paths, data, step_ms):
    """`[train-loop]`: the port's trainer, `train()`, at `PretrainConfig()`
    (the 6M UNet at full width and depth, crop 128^3, every augmentation)
    on the card: 8 steps over three 160^3 subjects with a val subject, the
    save and eval cadences at 4, then `continue_train` to 12. Every step's
    launches are `[train-step128]`'s, whose median step time (`step_ms`)
    is printed beside the loop's."""
    import tempfile

    from anatomix_tpu_torch.pretraining import train as train_mod
    from anatomix_tpu_torch.pretraining.config import PretrainConfig

    train_data, val_data = data
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PretrainConfig(name="loop", ckpt_dir=tmp, dataroot=tmp,
                             max_iters=8, print_freq=1, evaluation_freq=4,
                             n_val_during_train=1, save_latest_freq=4,
                             display_freq=0)
        run_dir = os.path.join(tmp, cfg.name)
        for tag, c, first, last in (
                ("train_loop", cfg, 0, 8),
                ("train_loop_resume",
                 PretrainConfig(**{**cfg.__dict__, "continue_train": True,
                                   "max_iters": 12}), 8, 12)):
            per_step = []
            undo = counted_steps(train_mod, wrappers, per_step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            try:
                state = train_mod.train(c, train_data, val_data, device=dev)
            finally:
                undo()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[tag] = counts(wrappers)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps, val = loop_scalars(run_dir)
            steps = steps[first:]
            log_loop("train-loop", per_step, steps)
            check_loop(f"train-loop ({tag})", per_step, steps,
                       paths["train"], first, last)
            if state.step != last:
                raise RuntimeError(f"train-loop: ended at {state.step}")
            missing = [n for n in (
                "train_opt.json", "latest_train_state.npz",
                "latest_net_G.npz", "latest_net_F.npz", "4_net_G.npz",
                "8_net_G.npz", "best_val_net_G.npz", "best_val_loss.txt",
                "visuals/latest_view1.nii.gz", "visuals/latest_seg.nii.gz")
                + (("12_net_G.npz",) if last == 12 else ())
                if not os.path.exists(os.path.join(run_dir, n))]
            if missing:
                raise RuntimeError(f"train-loop: missing {missing}")
            if not val or not all(v == v for v in val):
                raise RuntimeError(f"train-loop: val losses {val}")
            summary = loop_summary(per_step, steps)
            log(f"[train-loop] {tag}: steps {first} -> {last} in {wall:.2f} s "
                f"(set-up and val included); median of steps 2+: host step "
                f"{summary['median_step_ms']:.4f} ms, wait for the batch "
                f"{summary['median_data_ms']:.4f} ms, device "
                f"{summary['median_device_ms']:.4f} ms; [train-step128] "
                f"median {step_ms:.4f} ms; val losses {val}; "
                f"peak {peak:.2f} GiB; launches per step "
                f"{summary['launches_per_step']}; {nvidia_smi()}")
            out[tag] = dict(summary, wall_s=wall, val_losses=val,
                            peak_gib=peak)
    torch.cuda.empty_cache()
    return out


def run_train_loop_gate(torch, dev, data):
    """`[train-loop-gate]`: four consecutive batches of the loop's own
    pipeline (`BatchPipeline`: read, f16 / i16 transfer, the paired
    augmentation), four steps from one state on the kernels, four on the f32
    plain route, and four on the plain route with the views rounded to
    bf16. At each step the kernels' loss must sit within 2.5x the plain
    route's own spread under that rounding + 1e-3 of the plain loss
    (relative): the two-part rule of PERF.md section 2."""
    import numpy as np

    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.dataset import H5TwoViewDataset
    from anatomix_tpu_torch.pretraining.train import BatchPipeline, build_all

    cfg = PretrainConfig()
    ds = H5TwoViewDataset(data[0], cfg)
    pipe = BatchPipeline(ds, cfg, np.random.default_rng(cfg.seed), dev,
                         (cfg.seed, cfg.seed + 1))
    batches = []
    for i in range(4):
        views, segs = pipe([i % len(ds)])
        pipe.ready(views, segs)
        batches.append((views, segs))
    _, _, state0, step_k = build_all(cfg, 1000, device=dev)
    _, _, _, step_p = build_all(cfg, 1000, device=dev, plain=True)

    def run(step, bf16_views=False):
        state, losses = state0, []
        for i, (views, segs) in enumerate(batches):
            if bf16_views:
                views = views.to(torch.bfloat16).float()
            state, m = step(state, views, segs,
                            torch.Generator(device=dev).manual_seed(100 + i))
            losses.append(float(m["loss"]))
        return losses

    t0 = time.perf_counter()
    kern = run(step_k)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = run(step_p)
    t_p = time.perf_counter() - t0
    spread = run(step_p, bf16_views=True)
    rel_k = [abs(k - p) / abs(p) for k, p in zip(kern, plain)]
    rel_q = [abs(q - p) / abs(p) for q, p in zip(spread, plain)]
    bound = [2.5 * q + 1e-3 for q in rel_q]
    log(f"[train-loop-gate] losses on the kernels {kern}, plain f32 {plain}, "
        f"plain f32 on bf16 views {spread}; |kernels - plain| / |plain| "
        f"{['%.3e' % v for v in rel_k]} vs bound 2.5 x spread + 1e-3 "
        f"{['%.3e' % v for v in bound]}; 4 steps {t_k:.2f} s on the kernels, "
        f"{t_p:.2f} s plain")
    if not all(v == v for v in kern + plain + spread):
        raise RuntimeError("train-loop-gate: non-finite loss")
    bad = [i + 1 for i, (r, b) in enumerate(zip(rel_k, bound)) if not r <= b]
    if bad:
        raise RuntimeError(f"train-loop-gate: steps {bad} outside the bound: "
                           f"{rel_k} vs {bound}")
    del state0
    torch.cuda.empty_cache()
    return dict(kernels=kern, plain=plain, plain_bf16_views=spread,
                rel_err=rel_k, bound=bound, kernels_s=t_k, plain_s=t_p)


def run_vit_train_loop(torch, dev, wrappers, paths, data):
    """`[vit-train-loop]`: the trainer with `netG="primus"` (the 26M ViT
    at full width and depth, crop 128^3): 4 steps, no val; every step's
    launches are `[vit-train-step128]`'s."""
    import tempfile

    from anatomix_tpu_torch.pretraining import train as train_mod
    from anatomix_tpu_torch.pretraining.config import PretrainConfig

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PretrainConfig(netG="primus", name="vit", ckpt_dir=tmp,
                             dataroot=tmp, max_iters=4, print_freq=1,
                             evaluation_freq=1000, save_latest_freq=1000,
                             display_freq=0)
        per_step = []
        undo = counted_steps(train_mod, wrappers, per_step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        try:
            state = train_mod.train(cfg, data[0], device=dev)
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths["vit_train_loop"] = counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps, _ = loop_scalars(os.path.join(tmp, cfg.name))
    log_loop("vit-train-loop", per_step, steps)
    check_loop("vit-train-loop", per_step, steps, paths["vit_train"], 0, 4)
    if state.step != 4:
        raise RuntimeError(f"vit-train-loop: ended at {state.step}")
    summary = loop_summary(per_step, steps)
    log(f"[vit-train-loop] 4 steps in {wall:.2f} s (set-up included); median "
        f"of steps 2-4: host step {summary['median_step_ms']:.4f} ms, wait "
        f"for the batch {summary['median_data_ms']:.4f} ms, device "
        f"{summary['median_device_ms']:.4f} ms; peak {peak:.2f} GiB; launches "
        f"per step {summary['launches_per_step']}; {nvidia_smi()}")
    del state
    torch.cuda.empty_cache()
    return dict(summary, wall_s=wall, peak_gib=peak)


def profile_train_loop(torch, dev, out_dir, data):
    """P3 where the user pays it: one step of the trainer loop at
    `PretrainConfig()` under torch.profiler (CPU and CUDA activities; the
    window from the end of loop step 3 to the end of step 4, which holds
    the wait for the batch, the step and the worker's next batch), its
    host time by `record_function` range (`loop/*` in
    `pretraining/train.py`, `step/*` in `pretraining/train_step.py`) and
    the device's busy share; then one batch of the loop's pipeline on this
    thread (the profiler records the ranges of the thread that runs it;
    the loop's worker thread falls outside), by its `data/*` ranges."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from anatomix_tpu_torch.pretraining import train as train_mod
    from anatomix_tpu_torch.pretraining.config import PretrainConfig

    window = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=2, warmup=1, active=1))

    def hook():
        window.setdefault("end", []).append(time.perf_counter())
        prof.step()
        window.setdefault("start", []).append(time.perf_counter())

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PretrainConfig(name="prof", ckpt_dir=tmp, dataroot=tmp,
                             max_iters=5, print_freq=1,
                             evaluation_freq=1000, save_latest_freq=1000,
                             display_freq=0)
        per_step = []
        undo = counted_steps(train_mod, {}, per_step, hook)
        try:
            with prof:
                train_mod.train(cfg, data[0], device=dev)
        finally:
            undo()
    wall_ms = 1e3 * (window["end"][3] - window["start"][2])
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy_ms = sum(getattr(ev, attr) for ev in events
                  if is_device_work(ev)) / 1e3
    ranges = sorted(
        ((ev.key, ev.count, ev.cpu_time_total / 1e3) for ev in events
         if ev.key.startswith(RANGES) and ev.device_type == DeviceType.CPU),
        key=lambda r: -r[2])
    with open(os.path.join(out_dir, "profile_train_loop.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=80))
    log(f"[profile] train_loop step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for key, count, ms in ranges:
        log(f"[profile]   {ms:9.3f} ms host  {count:3d}x  {key}")

    # one batch of the pipeline, alone
    import numpy as np

    from anatomix_tpu_torch.pretraining.dataset import H5TwoViewDataset
    from anatomix_tpu_torch.pretraining.train import BatchPipeline

    pipe = BatchPipeline(H5TwoViewDataset(data[0], cfg), cfg,
                         np.random.default_rng(0), dev, (1, 2))
    pipe.ready(*pipe([0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as bprof:
        t0 = time.perf_counter()
        pipe.ready(*pipe([1]))
        torch.cuda.synchronize()
        batch_ms = 1e3 * (time.perf_counter() - t0)
    bev = bprof.key_averages()
    batch_busy = sum(getattr(ev, attr) for ev in bev
                     if is_device_work(ev)) / 1e3
    data_ranges = sorted(((ev.key, ev.count, ev.cpu_time_total / 1e3)
                          for ev in bev if ev.key.startswith("data/")
                          and ev.device_type == DeviceType.CPU),
                         key=lambda r: -r[2])
    log(f"[profile] one batch of the pipeline alone: wall {batch_ms:.2f} ms, "
        f"device busy {batch_busy:.2f} ms")
    for key, count, ms in data_ranges:
        log(f"[profile]   {ms:9.3f} ms host  {count:3d}x  {key}")
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                ranges=[dict(name=k, count=c, ms=m) for k, c, m in ranges],
                batch_ms=batch_ms, batch_busy_ms=batch_busy,
                data_ranges=[dict(name=k, count=c, ms=m)
                             for k, c, m in data_ranges])


# -----------------------------------------------------------------------------
# registration: ConvexAdam on the 6M UNet's features

REG_SIZE = 192
# bench.py's registration settings (`registration_solver_seconds_192`):
# the solver's, then the extraction's
REG_SOLVE_KW = dict(grid_sp=2, disp_hw=1, selected_niter=80, grid_sp_adam=2,
                    ic=True)
REG_BENCH_KW = dict(REG_SOLVE_KW, extract_strategy="full")


def seeded_pth(torch, plan, path):
    """A UNet's seeded weights (for the 6M UNet those of
    `load_model("scratch", seed=0)`) written as a `.pth`, so registration
    and segmentation load a file as a user would."""
    from anatomix_tpu_torch.models.unet import init_params

    torch.save(init_params(plan, torch.Generator().manual_seed(0)), path)
    return path


def structured_pair(torch, dev, size: int, seed: int = 5):
    """A seeded registration pair with labels (numpy, (size,)^3 f32): the
    fixed volume is a body ellipsoid holding a smooth field, with six
    labelled organ ellipsoids of distinct intensities (radii 3-5.5 % of
    the extent) and a constant background; the moving volume and its
    labels are the fixed ones warped (trilinear, nearest) by a known
    smooth displacement of at most 3 voxels."""
    import numpy as np

    from anatomix_tpu_torch.registration.warp import warp_volume

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)
    z, y, x = np.meshgrid(t, t, t, indexing="ij")
    body = (((z - 0.5) / 0.42) ** 2 + ((y - 0.5) / 0.4) ** 2
            + ((x - 0.5) / 0.38) ** 2) <= 1.0
    img = np.where(body, 100.0 + 40.0 * np.sin(3 * np.pi * z)
                   * np.cos(2 * np.pi * y) + 30.0 * np.sin(4 * np.pi * x),
                   0.0).astype(np.float32)
    seg = np.zeros_like(img)
    for lab in range(1, 7):
        c = rng.uniform(0.3, 0.7, 3)
        r = rng.uniform(0.03, 0.055, 3)
        inside = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                  + ((x - c[2]) / r[2]) ** 2) <= 1.0
        img[inside] = 150.0 + 100.0 * lab
        seg[inside] = lab
    u = np.stack([np.sin(2 * np.pi * y + 0.3) + 0.6 * np.cos(2 * np.pi * x),
                  np.cos(2 * np.pi * z) + 0.6 * np.sin(2 * np.pi * x + 1.0),
                  np.sin(2 * np.pi * z + 2.0) + 0.6 * np.cos(2 * np.pi * y)],
                 axis=-1)
    u *= 3.0 / np.sqrt((u ** 2).sum(-1)).max()
    u_t = torch.as_tensor(u[None], dtype=torch.float32, device=dev)

    def warp(a, mode):
        v = torch.as_tensor(a, device=dev)[None, ..., None]
        return warp_volume(v, u_t, mode=mode)[0, ..., 0].cpu().numpy()

    return img, seg, warp(img, "bilinear"), warp(seg, "nearest")


def neg_jacobian_share(torch, disp) -> float:
    """Share of voxels whose deformation has a negative Jacobian
    determinant (`jacobian_det` on the (x, y, z)-ordered field, whose
    identity has determinant 1)."""
    from anatomix_tpu_torch.registration.warp import (
        generate_grid,
        jacobian_det,
    )

    grid = generate_grid(disp.shape[1:4], device=disp.device)
    det = jacobian_det(torch.flip(disp, dims=(-1,)), grid)
    return (det < 0).float().mean().item()


def registration_routes(torch, dev, plan, sd, fixed, moving, strategy,
                        solve_kw, disp_kernels, tag):
    """The pair's solver inputs (`pair_features`) on three routes: the
    kernels (bf16), the plain f32 route (`impl="eager"`) and the plain
    route in bf16 (the eager module under bf16 autocast). Gates, with the
    smoke's two-part rule (TOL_MODEL; TOL_VS_BF16_PLAIN x the plain route
    in bf16 + TOL_VS_BF16_PLAIN_ABS): the network channels of each
    volume's merged features (mean|err|/std against the plain f32 route;
    the 12 MIND channels are the same on every route), and the field:
    mean|disp_kernels - disp_plain| against mean|disp_plain_bf16 -
    disp_plain|, each plain field from `solve` on its route's features.
    Recorded: mean|disp_kernels - solve(kernel features)|, two solves of
    the same inputs (the atomic `avg_pool3d` backward)."""
    from anatomix_tpu_torch.registration.pipeline import pair_features, solve

    def feats(**kw):
        return pair_features(fixed, moving, plan, sd, device=dev,
                             extract_strategy=strategy, **kw)

    plain_kw = dict(impl="eager", compute_dtype=torch.float32)
    routes = {"kernels": feats(), "plain": feats(**plain_kw)}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        routes["plain_bf16"] = feats(**plain_kw)
    out = {}
    for i, vol in enumerate(("fixed", "moving")):
        ref = routes["plain"][i][..., 12:]
        e = {r: mean_rel(routes[r][i][..., 12:], ref)
             for r in ("kernels", "plain_bf16")}
        out[f"features_{vol}"] = e
        log(f"[{tag}] {vol} features ({strategy}) vs the f32 plain route, "
            f"mean|err|/std: kernels {e['kernels']:.4e}, the plain route in "
            f"bf16 {e['plain_bf16']:.4e} (tol {TOL_MODEL} and "
            f"{TOL_VS_BF16_PLAIN}x plain bf16 + {TOL_VS_BF16_PLAIN_ABS})")
        two_part_gate(f"{tag} {vol} features", e["kernels"], e["plain_bf16"])
    disps = {r: solve(*f, **solve_kw) for r, f in routes.items()}
    del routes

    def mean_diff(a, b):
        return (a - b).abs().mean().item()

    d_k = mean_diff(disp_kernels, disps["plain"])
    d_b = mean_diff(disps["plain_bf16"], disps["plain"])
    d_rr = mean_diff(disp_kernels, disps["kernels"])
    limit = TOL_VS_BF16_PLAIN * d_b + TOL_VS_BF16_PLAIN_ABS
    out.update(mean_abs_disp_diff=d_k, plain_bf16_mean_abs_disp_diff=d_b,
               resolve_mean_abs_disp_diff=d_rr, disp_limit=limit)
    log(f"[{tag}] mean|disp - disp of the f32 plain route| (voxels): kernels "
        f"{d_k:.4e}, the plain route in bf16 {d_b:.4e} (limit {limit:.4e}); "
        f"a second solve of the kernels' features {d_rr:.4e}")
    if not d_k <= limit:
        raise RuntimeError(f"{tag}: mean|disp kernels - plain| {d_k:.4e} "
                           f"over {limit:.4e} (plain bf16 {d_b:.4e})")
    return out, disps["plain"]


def run_registration(torch, dev, wrappers, paths, plan, sd):
    """`[registration]` at bench.py's settings: a 192^3 pair of
    `default_rng(3)` uniform volumes x 500, the 6M UNet at full width
    with seeded weights from a `.pth`, `extract_strategy="full"`;
    `registration_solver_seconds_192` is the median solver time of three
    `register_pair` calls after a warm one. The features and the field
    are then held against the plain route (`registration_routes`)."""
    import numpy as np

    from anatomix_tpu_torch.extract import extract_features
    from anatomix_tpu_torch.registration.pipeline import register_pair

    rng = np.random.default_rng(3)
    fixed = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500
    moving = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500
    register_pair(fixed, moving, plan, sd, device=dev, **REG_BENCH_KW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver_s, walls = [], []
    for i in range(3):
        if i == 0:
            reset_counts(wrappers)
        (disp, s), wall = timed(torch, lambda: register_pair(
            fixed, moving, plan, sd, device=dev, **REG_BENCH_KW))
        if i == 0:
            launched = paths["registration_full"] = counts(wrappers)
        solver_s.append(s)
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_path("registration", disp, (1, REG_SIZE, REG_SIZE, REG_SIZE, 3),
               launched, ["conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc"])
    _, extract_s = timed(torch, lambda: extract_features(
        fixed, moving, plan, sd, strategy="full", device=dev))
    out = dict(registration_solver_seconds_192=statistics.median(solver_s),
               solver_s=solver_s, pair_wall_s=walls, extract_s=extract_s,
               peak_gib=peak, launches=launched,
               max_abs_disp=disp.abs().max().item())
    log(f"[registration] 192^3 pair (bench.py settings: {REG_BENCH_KW}): "
        f"registration_solver_seconds_192 {out['registration_solver_seconds_192']:.4f}"
        f" (median of {['%.4f' % v for v in solver_s]}); extraction of both "
        f"volumes {extract_s:.4f} s; whole pair {['%.4f' % v for v in walls]}"
        f" s; peak {peak:.2f} GiB; max|disp| {out['max_abs_disp']:.3f}; "
        f"launches {launched}; {nvidia_smi()}")
    out["check"], _ = registration_routes(torch, dev, plan, sd, fixed,
                                          moving, "full", REG_SOLVE_KW, disp,
                                          "registration")
    torch.cuda.empty_cache()
    return out


def run_registration_gate(torch, dev, wrappers, paths, plan, sd, pair):
    """`[registration-gate]`: the structured 192^3 pair registered by
    `register_pair` at the CLI's defaults (`sliding`) on the kernels
    (bf16), then `registration_routes` (features and field against the
    plain route). Gate: the kernels' macro-Dice after >= before + 0.1 and
    >= the plain f32 route's - 0.02. Recorded: the share of negative
    Jacobians on each route."""
    from anatomix_tpu_torch.registration.pipeline import (
        macro_dice,
        register_pair,
    )
    from anatomix_tpu_torch.registration.warp import warp_volume

    fixed, fseg, moving, mseg = pair
    before = macro_dice(fseg, mseg)
    mseg_t = torch.as_tensor(mseg, device=dev)[None, ..., None]
    reset_counts(wrappers)
    (disp, solver_s), wall = timed(torch, lambda: register_pair(
        fixed, moving, plan, sd, device=dev))
    launched = paths["registration_sliding"] = counts(wrappers)
    check_path("registration-gate", disp,
               (1, REG_SIZE, REG_SIZE, REG_SIZE, 3), launched,
               ["conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc", "blend_scatter"])
    res = dict(dice_before=before, launches=launched, wall_s=wall,
               solver_s=solver_s)
    res["check"], disp_plain = registration_routes(
        torch, dev, plan, sd, fixed, moving, "sliding", {}, disp,
        "registration-gate")
    for route, d in (("kernels", disp), ("plain", disp_plain)):
        moved = warp_volume(mseg_t, d, mode="nearest")[0, ..., 0]
        res[route] = dict(dice=macro_dice(fseg, moved.cpu().numpy()),
                          neg_jacobian_share=neg_jacobian_share(torch, d))
    k, p = res["kernels"], res["plain"]
    log(f"[registration-gate] structured 192^3 pair, sliding: macro-Dice "
        f"before {before:.4f}; kernels {k['dice']:.4f} (pair {wall:.3f} s, "
        f"solver {solver_s:.4f} s, negative Jacobians "
        f"{k['neg_jacobian_share']:.3e}); plain f32 {p['dice']:.4f} "
        f"(negative Jacobians {p['neg_jacobian_share']:.3e}); launches "
        f"{launched}")
    if not (k["dice"] >= before + 0.1 and k["dice"] >= p["dice"] - 0.02):
        raise RuntimeError(
            f"registration-gate: Dice {k['dice']:.4f} against before "
            f"{before:.4f} + 0.1 and plain {p['dice']:.4f} - 0.02")
    del disp, disp_plain
    torch.cuda.empty_cache()
    return res


def run_registration_cli(torch, dev, wrappers, paths, ckpt, pair):
    """`[registration-cli]`: `python -m anatomix_tpu_torch.registration.cli`
    once on NIfTI files of the structured pair, with masks from the labels
    (so the EDT infill runs on the card) and `--warp_seg`: the three output
    files and the printed Dice are checked."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from anatomix_tpu_torch.registration.cli import main as cli_main
    from anatomix_tpu_torch.utils.nifti import load_volume, save_volume

    fixed, fseg, moving, mseg = pair
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for name, arr in (("fixed", fixed), ("moving", moving),
                          ("fixed_seg", fseg), ("moving_seg", mseg),
                          ("fixed_mask", (fseg > 0).astype(np.float32)),
                          ("moving_mask", (mseg > 0).astype(np.float32))):
            files[name] = os.path.join(tmp, f"{name}.nii")
            save_volume(files[name], arr, np.eye(4))
        out_dir = os.path.join(tmp, "out")
        buf = io.StringIO()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main([
                "--fixed", files["fixed"], "--moving", files["moving"],
                "--exp_name", "smoke", "--ckpt_path", ckpt,
                "--use_mask", "--path_mask_fixed", files["fixed_mask"],
                "--path_mask_moving", files["moving_mask"], "--warp_seg",
                "--path_seg_fixed", files["fixed_seg"],
                "--path_seg_moving", files["moving_seg"],
                "--result_path", out_dir, "--device", str(dev)])
        wall = time.perf_counter() - t0
        launched = paths["registration_cli"] = counts(wrappers)
        text = buf.getvalue()
        dice = [float(line.split(":", 1)[1]) for line in text.splitlines()
                if line.startswith("Dice:")]
        shapes = {}
        for prefix in ("disp_", "moved_", "labels_moved_"):
            names = [f for f in os.listdir(out_dir) if f.startswith(prefix)]
            if len(names) != 1:
                raise RuntimeError(f"registration-cli: {prefix}* {names}")
            vol, _ = load_volume(os.path.join(out_dir, names[0]))
            if not np.isfinite(vol).all():
                raise RuntimeError(f"registration-cli: {names[0]} non-finite")
            shapes[prefix] = vol.shape
    want = {"disp_": (REG_SIZE,) * 3 + (3,), "moved_": (REG_SIZE,) * 3,
            "labels_moved_": (REG_SIZE,) * 3}
    if shapes != want or len(dice) != 1 or not 0.0 <= dice[0] <= 1.0:
        raise RuntimeError(f"registration-cli: shapes {shapes}, Dice {dice};"
                           f" output {text!r}")
    missing = [k for k in ("conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc",
                           "blend_scatter") if launched[k] == 0]
    if missing:
        raise RuntimeError(f"registration-cli: kernels not launched {missing}")
    log(f"[registration-cli] --use_mask --warp_seg on the structured pair: "
        f"Dice {dice[0]:.4f} in {wall:.3f} s (file IO included); outputs "
        f"{shapes}; launches {launched}")
    return dict(dice=dice[0], wall_s=wall, launches=launched)


def profile_registration(torch, dev, out_dir, plan, sd):
    """The registration pair of `[registration]` under torch.profiler:
    (1) the solver alone (the grid pooling, stage 1 and the 80 Adam
    iterations on the merged features), its device busy share and top
    device operations; (2) the whole `register_pair` and the image warp,
    host time by `reg/*` range."""
    import numpy as np

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anatomix_tpu_torch.registration.pipeline import (
        pair_features,
        register_pair,
        solve,
    )
    from anatomix_tpu_torch.registration.warp import warp_volume

    rng = np.random.default_rng(3)
    fixed = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500
    moving = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500
    ffix, fmov = pair_features(fixed, moving, plan, sd, device=dev,
                               extract_strategy="full")
    solve(ffix, fmov, **REG_SOLVE_KW)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(ffix, fmov, **REG_SOLVE_KW)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted(((getattr(ev, attr) / 1e3, ev.count, ev.key)
                   for ev in events if is_device_work(ev)
                   and getattr(ev, attr) > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, "profile_registration_solver.txt"),
              "w") as f:
        f.write(events.table(sort_by=attr, row_limit=60))
    log(f"[profile] registration solver 192^3: wall {wall_ms:.2f} ms, device "
        f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for ms, count, key in rows[:16]:
        log(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")

    mov_t = torch.as_tensor(moving, device=dev)[None, ..., None]
    with profile(activities=acts) as prof2:
        t0 = time.perf_counter()
        disp, _ = register_pair(fixed, moving, plan, sd, device=dev,
                                **REG_BENCH_KW)
        warp_volume(mov_t, disp)
        torch.cuda.synchronize()
        pair_ms = 1e3 * (time.perf_counter() - t0)
    ev2 = prof2.key_averages()
    pair_busy = sum(getattr(ev, attr) for ev in ev2
                    if is_device_work(ev)) / 1e3
    ranges = sorted(((ev.key, ev.count, ev.cpu_time_total / 1e3)
                     for ev in ev2 if ev.key.startswith("reg/")
                     and ev.device_type == DeviceType.CPU),
                    key=lambda r: -r[2])
    with open(os.path.join(out_dir, "profile_registration_pair.txt"),
              "w") as f:
        f.write(ev2.table(sort_by="cpu_time_total", row_limit=60))
    log(f"[profile] register_pair + warp 192^3: wall {pair_ms:.2f} ms, device "
        f"busy {pair_busy:.2f} ms ({100 * pair_busy / pair_ms:.1f} %); host "
        f"time by range:")
    for key, count, ms in ranges:
        log(f"[profile]   {ms:9.3f} ms host  {count:3d}x  {key}")
    torch.cuda.empty_cache()
    return dict(solver_wall_ms=wall_ms, solver_busy_ms=busy_ms,
                top=[dict(ms=r[0], count=r[1], name=r[2]) for r in rows[:20]],
                pair_wall_ms=pair_ms, pair_busy_ms=pair_busy,
                ranges=[dict(name=k, count=c, ms=m) for k, c, m in ranges])



# -----------------------------------------------------------------------------
# segmentation: few-shot finetuning of the 6M UNet

SEG_CLASSES = 4
SEG_TRAIN_SIZE = 192
SEG_VAL_SIZE = 256
# the CLI's defaults (`segmentation/train.py` build_parser)
SEG_CROP = 128
SEG_BATCH = 3
SEG_LR = 2e-4
SEG_EPOCHS = 500
SEG_ITERS = 75
SEG_STEPS = 40  # the learning check's steps on each route
SEG_GATE_STEPS = 4  # the steps held to the plain route's bf16 spread


def seg_subject(size: int, seed: int):
    """A seeded structured subject (numpy, (size,)^3): a smoothly textured
    background (int16 CT-like values, two sinusoids) holding labelled
    ellipsoids of classes 1-4, three of each, of distinct intensities
    (radii 5-12 % of the extent); the labels uint8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)
    texture = (20.0 * np.sin(3 * np.pi * t)[:, None, None]
               * np.cos(2 * np.pi * t)[None, :, None]
               + 15.0 * np.sin(4 * np.pi * t)[None, None, :])
    img = 60.0 + texture
    lab = np.zeros((size,) * 3, np.uint8)
    for c in range(1, SEG_CLASSES + 1):
        for _ in range(3):
            ctr = rng.uniform(0.2, 0.8, 3)
            r = rng.uniform(0.05, 0.12, 3)
            # the ellipsoid's bounding box, then the voxels inside it
            lo = np.searchsorted(t, ctr - r)
            hi = np.searchsorted(t, ctr + r, side="right")
            box = tuple(slice(a, b) for a, b in zip(lo, hi))
            q = sum(((t[sl] - ctr[a]) / r[a]).reshape(
                [-1 if k == a else 1 for k in range(3)]) ** 2
                for a, sl in enumerate(box))
            inside = q <= 1.0
            lab[box][inside] = c
            img[box][inside] = 100.0 + 60.0 * c + 0.3 * texture[box][inside]
    return img.astype(np.int16), lab


def seg_dataset(root: str) -> str:
    """Three 192^3 training subjects and one 256^3 validation subject as
    NIfTI (`.nii.gz`) under `root` in the imagesTr/labelsTr/imagesVal/
    labelsVal layout, written by a thread each (gzip releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from anatomix_tpu_torch.utils.nifti import save_volume

    jobs = [("Tr", f"case{i}", SEG_TRAIN_SIZE, 70 + i) for i in range(3)]
    jobs.append(("Val", "case9", SEG_VAL_SIZE, 79))
    for sub in ("imagesTr", "labelsTr", "imagesVal", "labelsVal"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def write(job):
        split, name, size, seed = job
        img, lab = seg_subject(size, seed)
        save_volume(os.path.join(root, f"images{split}", f"{name}.nii.gz"),
                    img)
        save_volume(os.path.join(root, f"labels{split}", f"{name}.nii.gz"),
                    lab)

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(write, jobs))
    return root


def seg_model(torch, dev, ckpt, lr=SEG_LR, plain=False):
    """The 6M UNet from the seeded `.pth` and a fresh head, its Adam and
    train step on the CLI's schedule (constant over these steps)."""
    from anatomix_tpu_torch.segmentation.model import load_seg_model
    from anatomix_tpu_torch.segmentation.train import (
        build_seg_train_step,
        cosine_annealing,
        make_seg_optimizer,
    )

    plan, params = load_seg_model(SEG_CLASSES, ckpt_path=ckpt, device=dev)
    # the CLI's epoch: 3 subjects x (75 x 3 // 3) samples, 75 steps
    step = build_seg_train_step(
        plan, make_seg_optimizer(params, lr),
        cosine_annealing(lr, SEG_EPOCHS, SEG_ITERS), plain=plain)
    return plan, params, step


def seg_val_logits(torch, plan, params, vol, plain=False):
    """The validation volume's sliding-window logits as `validate` takes
    them (roi = crop, overlap 0.7, sw_batch 4, constant blend)."""
    from anatomix_tpu_torch.ops.sliding_window import (
        sliding_window_inference,
    )
    from anatomix_tpu_torch.segmentation.model import make_seg_predictor

    return sliding_window_inference(
        vol[None, ..., None], make_seg_predictor(plan, params, plain=plain),
        SEG_CLASSES + 1, roi_size=(SEG_CROP,) * 3, sw_batch_size=4,
        overlap=0.7, mode="constant")


def seg_backward_check(torch, kt, plan, ckpt, dev, batch):
    """The first step's loss and gradients from the initial state on the
    first batch: (a) the kernel route, recording each T-x / T-w launch
    with its inputs; (b) the same forward with the conv backward on the
    plain versions; (c) the plain f32 route; (d) the plain route on the
    images rounded to bf16. (a) vs (b) holds the backward on the kernels
    against the plain backward of the same activations; (a) vs (c) is the
    end-to-end dW error and (d) vs (c) its floor."""
    from anatomix_tpu_torch.segmentation.model import load_seg_model
    from anatomix_tpu_torch.segmentation.train import (
        seg_loss,
        trainable_leaves,
    )

    records = []

    def rec(fn, which):
        def call(a, b, *, pad_type):
            out = fn(a, b, pad_type=pad_type)
            records.append((which, (a, b), pad_type, out))
            return out
        return call

    def run(images, plain=False):
        params = load_seg_model(SEG_CLASSES, ckpt_path=ckpt, device=dev)[1]
        leaves = trainable_leaves(params)
        for _, v in leaves:
            v.requires_grad_()
        loss, _ = seg_loss(plan, params, images, batch[1], plain=plain)
        grads = torch.autograd.grad(loss, [v for _, v in leaves])
        return loss.item(), {name.split("/", 1)[1]: g for (name, _), g in
                             zip(leaves, grads)}

    with kt.backward_route(rec(kt.conv3x3x3_dgrad_ndhwc, "dgrad"),
                           rec(kt.conv3x3x3_wgrad_ndhwc, "wgrad")):
        loss_k, grads_k = run(batch[0])
    with kt.backward_route(kt.conv3x3x3_dgrad_ndhwc_plain,
                           kt.conv3x3x3_wgrad_ndhwc_plain):
        loss_b, grads_b = run(batch[0])
    loss_p, grads_p = run(batch[0], plain=True)
    _, grads_q = run(batch[0].to(torch.bfloat16).float(), plain=True)

    def dw_err(grads, ref):
        return {i: float((grads[f"model.{i}.weight"]
                          - ref[f"model.{i}.weight"]).abs().mean()
                         / ref[f"model.{i}.weight"].std())
                for i in plan.conv_indices}

    from anatomix_tpu_torch.models.unet import prelu_key

    pkey = prelu_key(plan)
    prelu = {}
    if pkey:
        # the shared PReLU weight's gradient against the plain backward's
        prelu["prelu_backward"] = float(
            (grads_k[pkey] - grads_b[pkey]).abs().max()
            / grads_b[pkey].abs().max())
    launches = {"wgrad": [], "dgrad": [], "dgrad_shell": []}
    for which, args, pad, got in records:
        plain_fn = (kt.conv3x3x3_wgrad_ndhwc_plain if which == "wgrad"
                    else kt.conv3x3x3_dgrad_ndhwc_plain)
        ref = plain_fn(*args, pad_type=pad)
        launches[which].append(rel_err(got, ref)[1])
        if which == "dgrad":
            launches["dgrad_shell"].append(shell_rel_err(torch, got, ref))
    return dict(loss_kernels=loss_k, loss_same_forward=loss_b,
                loss_plain=loss_p, dw_backward=dw_err(grads_k, grads_b),
                dw_end_to_end=dw_err(grads_k, grads_p),
                dw_floor=dw_err(grads_q, grads_p), launch_errs=launches)


def run_segmentation(torch, dev, wrappers, paths, kt, ckpt, root):
    """Phase 11: few-shot finetuning at the CLI's defaults (the 6M UNet at
    full width from a seeded `.pth`, 4 classes, crop 128^3, batch 3, Adam
    at 2e-4, DiceCE) on three 192^3 subjects, validated on a 256^3 one.

    `[segmentation]`: `segmentation_val_seconds_256` (one `validate` of
    the 256^3 volume: 125 windows in 32 chunks of 4, host clock between
    synchronizes, before and after training) and 40 steps on the
    kernels, each batch read and transformed by `train.load_batch`:
    `segmentation_step_seconds_128crop`, the median of steps 2+ on the host
    clock between `torch.cuda.synchronize()`, beside its CUDA-event time,
    the host-clock wait for the batch, the launches of each step and the
    peak memory.

    `[segmentation-gate]`: the same 40 batches stepped from the same state
    on the plain f32 route (`plain=True`), and the first 4 on the plain
    route with the images rounded to bf16. Gates: the first loss within
    1e-2; each of the first 4 losses within 2.5x the plain route's spread
    + 1e-3; every T-x / T-w launch of the first step against its plain
    version and the step's dW against the plain backward from the same
    forward (`seg_backward_check`); the validation logits after the
    kernels' 40 steps, the fused forward against the plain route on the
    same parameters, to the two-part rule, and their Dice losses within
    0.02; on both routes the last 5 train losses' mean under 0.8x the
    first 5's and the validation Dice loss lower after training."""
    import numpy as np

    from anatomix_tpu_torch.ops.sliding_window import compute_window_starts
    from anatomix_tpu_torch.segmentation.data import (
        VolumeCache,
        data_handler,
    )
    from anatomix_tpu_torch.segmentation.losses import dice_loss
    from anatomix_tpu_torch.segmentation.train import load_batch, validate
    from anatomix_tpu_torch.segmentation.transforms import val_transform

    tri, trs, vai, vas = data_handler(root, 3, SEG_STEPS, SEG_BATCH)
    cache = VolumeCache(dev)
    _, load_s = timed(torch, lambda: [cache.get(p) for p in tri[:3] + trs[:3]
                                      + vai + vas])
    val_vol = val_transform(cache.get(vai[0]))
    val_lab = cache.get(vas[0])
    order = np.random.default_rng(0).permutation(len(tri))
    gen = torch.Generator().manual_seed(0)
    field_gen = torch.Generator(device=dev).manual_seed(0)
    plan, params, step = seg_model(torch, dev, ckpt)
    n_conv = len(plan.conv_indices)
    n_resize = sum(spec.kind in ("pool", "upsample") for spec in plan.layers)
    want = {k: 0 for k in wrappers}
    want.update({"conv3x3x3_ndhwc": n_conv, "conv3x3x3_wgrad_ndhwc": n_conv,
                 "conv3x3x3_dgrad_ndhwc": n_conv - 1,
                 "pad_shell_ndhwc": n_conv - 1,
                 "space_to_depth2_ndhwc": n_resize,
                 "depth_to_space2_ndhwc": n_resize})

    def val_timed(tag):
        reset_counts(wrappers)
        dl, sec = timed(torch, lambda: validate(
            plan, params, vai, vas, cache, SEG_CROP, SEG_CLASSES,
            plain=False))
        paths[tag] = counts(wrappers)
        return dl, sec

    val_before, val_before_s = val_timed("segmentation_val_256")
    n_win = len(compute_window_starts((SEG_VAL_SIZE,) * 3, (SEG_CROP,) * 3,
                                      0.7))
    chunks = -(-n_win // 4)
    want_val = {k: 0 for k in wrappers}
    want_val.update({"conv3x3x3_ndhwc": 16 * chunks,
                     "conv3x3x3_upcat_ndhwc": 4 * chunks,
                     "blend_scatter": chunks})
    if paths["segmentation_val_256"] != want_val:
        raise RuntimeError(f"segmentation: validation launches "
                           f"{paths['segmentation_val_256']}, want {want_val}")

    batches, losses, host_s, dev_ms, data_s, per_step = [], [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    for i in range(SEG_STEPS):
        idxs = order[i * SEG_BATCH:(i + 1) * SEG_BATCH]
        batch, t_data = timed(torch, lambda: load_batch(
            cache, tri, trs, idxs, SEG_CROP, gen, field_gen))
        batches.append(batch)
        before = counts(wrappers)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        loss = step(params, *batch)
        ev1.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        dev_ms.append(ev0.elapsed_time(ev1))
        data_s.append(t_data)
        losses.append(float(loss))
        per_step.append({k: v - before[k] for k, v in counts(wrappers).items()})
        if i == 0:
            # the first step's peak (Adam's moments included), before the
            # batches kept for the plain route pile up
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    paths["segmentation_train"] = counts(wrappers)
    val_after, val_after_s = val_timed("segmentation_val_256_after")
    if paths["segmentation_val_256_after"] != want_val:
        raise RuntimeError("segmentation: validation launches after training "
                           f"{paths['segmentation_val_256_after']}")
    bad = [i + 1 for i, c in enumerate(per_step) if c != want]
    if bad:
        raise RuntimeError(f"segmentation: launches of step {bad[0]} "
                           f"{per_step[bad[0] - 1]}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"segmentation: non-finite loss {losses}")
    res = dict(
        segmentation_step_seconds_128crop=statistics.median(host_s[1:]),
        segmentation_val_seconds_256=val_after_s,
        val_before_training_s=val_before_s, step_device_ms=dev_ms,
        step_host_s=host_s, data_s=data_s, losses=losses, peak_gib=peak,
        launches_per_step=per_step[0], val_launches=want_val,
        windows=n_win, chunks=chunks, volume_load_s=load_s,
        val_dice_loss=dict(kernels_before=val_before,
                           kernels_after=val_after))
    log(f"[segmentation] 6M UNet, {SEG_CLASSES} classes, crop {SEG_CROP}^3 x "
        f"batch {SEG_BATCH}, Adam {SEG_LR}, {SEG_STEPS} steps on three "
        f"{SEG_TRAIN_SIZE}^3 subjects (read in {load_s:.3f} s): "
        f"segmentation_step_seconds_128crop "
        f"{res['segmentation_step_seconds_128crop']:.4f} (median of steps "
        f"2+, host clock); CUDA events median "
        f"{statistics.median(dev_ms[1:]):.4f} ms; wait for the batch "
        f"median {1e3 * statistics.median(data_s[1:]):.4f} ms; peak "
        f"{peak:.2f} GiB (the first step); launches per step {per_step[0]}; "
        f"{nvidia_smi()}")
    log(f"[segmentation] segmentation_val_seconds_256 {val_after_s:.4f} "
        f"(before training {val_before_s:.4f}; {n_win} windows in {chunks} "
        f"chunks of 4, roi {SEG_CROP}, overlap 0.7, constant; launches "
        f"{want_val}); val Dice loss {val_before:.4f} -> {val_after:.4f}")
    log(f"[segmentation] losses {['%.4f' % v for v in losses]}")

    # [segmentation-gate]: the plain route on the same batches
    gate = seg_backward_check(torch, kt, plan, ckpt, dev, batches[0])
    _, pparams, pstep = seg_model(torch, dev, ckpt, plain=True)
    p_before = validate(plan, pparams, vai, vas, cache, SEG_CROP,
                        SEG_CLASSES, plain=True)
    t0 = time.perf_counter()
    plain = [float(pstep(pparams, *b)) for b in batches]
    plain_s = time.perf_counter() - t0
    p_after = validate(plan, pparams, vai, vas, cache, SEG_CROP,
                       SEG_CLASSES, plain=True)
    del pparams
    _, qparams, qstep = seg_model(torch, dev, ckpt, plain=True)
    spread = [float(qstep(qparams, b[0].to(torch.bfloat16).float(), b[1]))
              for b in batches[:SEG_GATE_STEPS]]
    del qparams
    rel_k = [abs(k - p) / abs(p) for k, p in zip(losses, plain)]
    rel_q = [abs(q - p) / abs(p) for q, p in zip(spread, plain)]
    bound_q = [TOL_VS_BF16_PLAIN * q + TOL_VS_BF16_PLAIN_ABS for q in rel_q]
    # the validation logits after the kernels' steps, on the same
    # parameters: the fused forward, the plain f32 route, and the plain
    # route in bf16
    routes = {"kernels": seg_val_logits(torch, plan, params, val_vol),
              "plain": seg_val_logits(torch, plan, params, val_vol, True)}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        routes["plain_bf16"] = seg_val_logits(torch, plan, params, val_vol,
                                              True)
    e = {r: mean_rel(routes[r], routes["plain"])
         for r in ("kernels", "plain_bf16")}
    dice = {r: float(dice_loss(v, val_lab[None])) for r, v in routes.items()}
    del routes
    learn = {}
    for route, curve, (before, after) in (
            ("kernels", losses, (val_before, val_after)),
            ("plain", plain, (p_before, p_after))):
        first, last = np.mean(curve[:5]), np.mean(curve[-5:])
        learn[route] = dict(first5=float(first), last5=float(last),
                            val_before=before, val_after=after)
    errs = gate["launch_errs"]
    log(f"[segmentation-gate] first loss {losses[0]:.6f} (seg_loss on the "
        f"kernels {gate['loss_kernels']!r}, with the plain conv backward "
        f"{gate['loss_same_forward']!r}) vs the plain f32 route "
        f"{plain[0]:.6f}: rel {rel_k[0]:.3e} (tol {TOL_TRAIN_LOSS})")
    log(f"[segmentation-gate] losses of steps 1-{SEG_GATE_STEPS}: kernels "
        f"{losses[:SEG_GATE_STEPS]}, plain f32 {plain[:SEG_GATE_STEPS]}, "
        f"plain f32 on bf16 images {spread}; |kernels - plain| / |plain| "
        f"{['%.3e' % v for v in rel_k[:SEG_GATE_STEPS]]} vs bound "
        f"{['%.3e' % v for v in bound_q]}; {SEG_STEPS} plain steps "
        f"{plain_s:.2f} s")
    log(f"[segmentation-gate] the first step's {len(errs['wgrad'])} wgrad and "
        f"{len(errs['dgrad'])} dgrad launches vs their plain versions on the "
        f"same tensors: max rel {max(errs['wgrad']):.3e} (tol {TOL_WGRAD}), "
        f"{max(errs['dgrad']):.3e} (tol {TOL_CONV_BF16}); the reflect shell "
        f"alone {max(errs['dgrad_shell']):.3e}")
    log(f"[segmentation-gate] dW mean|err|/std, the backward on the kernels "
        f"vs the plain conv backward from the same forward (tol "
        f"{TOL_TRAIN_DW}): {fmt_dw(gate['dw_backward'])}")
    log(f"[segmentation-gate] dW end to end vs the plain f32 route: "
        f"{fmt_dw(gate['dw_end_to_end'])}; the plain route on bf16 images "
        f"vs itself: {fmt_dw(gate['dw_floor'])}")
    log(f"[segmentation-gate] validation logits after {SEG_STEPS} steps, "
        f"same parameters, vs the plain f32 route, mean|err|/std: fused "
        f"kernels {e['kernels']:.4e}, the plain route in bf16 "
        f"{e['plain_bf16']:.4e} (tol {TOL_MODEL} and {TOL_VS_BF16_PLAIN}x "
        f"plain bf16 + {TOL_VS_BF16_PLAIN_ABS}); Dice loss kernels "
        f"{dice['kernels']:.4f}, plain {dice['plain']:.4f}, plain bf16 "
        f"{dice['plain_bf16']:.4f} (tol 0.02)")
    for route, r in learn.items():
        log(f"[segmentation-gate] learning on the {route} route: train loss "
            f"mean of steps 1-5 {r['first5']:.4f}, of steps "
            f"{SEG_STEPS - 4}-{SEG_STEPS} {r['last5']:.4f} (want < 0.8x); "
            f"val Dice loss {r['val_before']:.4f} -> {r['val_after']:.4f}")
    if not rel_k[0] < TOL_TRAIN_LOSS:
        raise RuntimeError(f"segmentation-gate: first loss {losses[0]} vs "
                           f"{plain[0]}")
    bad = [i + 1 for i, (r, b) in enumerate(zip(rel_k, bound_q))
           if not r <= b]
    if bad:
        raise RuntimeError(f"segmentation-gate: steps {bad} outside the "
                           f"bound: {rel_k[:SEG_GATE_STEPS]} vs {bound_q}")
    if (len(errs["wgrad"]), len(errs["dgrad"])) != (n_conv, n_conv - 1):
        raise RuntimeError(f"segmentation-gate: recorded {errs}")
    if not (max(errs["wgrad"]) < TOL_WGRAD
            and max(errs["dgrad"]) < TOL_CONV_BF16
            and max(errs["dgrad_shell"]) < TOL_CONV_BF16):
        raise RuntimeError(f"segmentation-gate: kernel errors {errs}")
    if not max(gate["dw_backward"].values()) < TOL_TRAIN_DW:
        raise RuntimeError(f"segmentation-gate: backward dW "
                           f"{gate['dw_backward']} over {TOL_TRAIN_DW}")
    two_part_gate("segmentation-gate validation logits", e["kernels"],
                  e["plain_bf16"])
    if not abs(dice["kernels"] - dice["plain"]) <= 0.02:
        raise RuntimeError(f"segmentation-gate: Dice losses {dice}")
    for route, r in learn.items():
        if not (r["last5"] < 0.8 * r["first5"]
                and r["val_after"] < r["val_before"]):
            raise RuntimeError(f"segmentation-gate: no learning on the "
                               f"{route} route: {r}")
    res["gate"] = dict(
        plain_losses=plain, plain_bf16_losses=spread, rel_err=rel_k,
        bound=bound_q, plain_steps_s=plain_s, first_step=gate,
        val_logits=e, val_dice_loss=dice, learning=learn)
    del batches, params, cache
    torch.cuda.empty_cache()
    return res


def run_segmentation_cli(torch, dev, wrappers, paths, source, root, *,
                         tag="segmentation-cli", epochs=2,
                         expect=("conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc",
                                 "blend_scatter", "conv3x3x3_wgrad_ndhwc",
                                 "conv3x3x3_dgrad_ndhwc",
                                 "space_to_depth2_ndhwc",
                                 "depth_to_space2_ndhwc")):
    """`[segmentation-cli]`: `python -m anatomix_tpu_torch.segmentation.
    train` on the NIfTI dataset with the backbone `source` (its CLI
    arguments: `--pretrained_ckpt` or `--hf_variant` and `--cache_path`),
    `--n_epochs epochs --n_iters_per_epoch 4 --val_interval 1` (the
    CLI's other defaults: crop 128, batch 3, lr 2e-4), run from a temporary
    working directory: the best and per-epoch checkpoints, the scalars,
    finite losses, and every kernel of `expect` launched."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from anatomix_tpu_torch.segmentation.train import build_parser, main
    from anatomix_tpu_torch.utils.checkpoint import load_pytree

    iters = 4
    argv = ["--exp_name", "smoke", "--dataset", root, "--n_classes",
            str(SEG_CLASSES), *source, "--crop_size", str(SEG_CROP),
            "--n_epochs", str(epochs), "--n_iters_per_epoch", str(iters),
            "--val_interval", "1", "--device", str(dev)]
    cwd = os.getcwd()
    buf = io.StringIO()
    last = f"epoch{epochs:04d}.npz"
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts(wrappers)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main(build_parser().parse_args(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[tag.replace("-", "_")] = launched = counts(wrappers)
            ckpt_dir = os.path.join("finetuning_runs", "checkpoints", "smoke")
            names = sorted(os.listdir(ckpt_dir))
            state = load_pytree(os.path.join(ckpt_dir, last))
            with open(os.path.join("finetuning_runs", "runs", "smoke",
                                   "scalars.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        finally:
            os.chdir(cwd)
    train = [r["train_loss"] for r in recs if "train_loss" in r]
    val = [r["val_loss_mean_dice"] for r in recs if "val_loss_mean_dice" in r]
    if not ({f"epoch{e + 1:04d}.npz" for e in range(epochs)} <= set(names)
            and any(n.startswith("best_dict_epoch") for n in names)):
        raise RuntimeError(f"{tag}: checkpoints {names}")
    if (int(state["epoch"]) != epochs
            or int(state["opt_state"]["count"]) != epochs * iters):
        raise RuntimeError(f"{tag}: epoch {state['epoch']}, "
                           f"count {state['opt_state']['count']}")
    if (len(train) != epochs * iters or len(val) != epochs
            or not np.isfinite(train + val).all()):
        raise RuntimeError(f"{tag}: losses {train}, val {val}")
    missing = [k for k in expect if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{tag}: kernels not launched {missing}")
    log(f"[{tag}] {epochs} epochs x {iters} steps, val every epoch, in "
        f"{wall:.2f} s (reads and checkpoints included): train losses "
        f"{['%.4f' % v for v in train]}, val Dice loss {val}; checkpoints "
        f"{names}; launches {launched}")
    return dict(wall_s=wall, train_losses=train, val_losses=val,
                checkpoints=names, launches=launched)


# the dev backbone's finetuning: the steps on the kernels (the first four
# also on the plain routes), and the size its validation logits are held
# to the plain route at
DEV_SEG_STEPS = 10
DEV_SEG_GATE_SIZE = 160
# the dev validation's kernels: K1, the decoder's D2 then D3, the live
# norms' D1 and the stitch
DEV_VAL_KERNELS = ("conv3x3x3_ndhwc", "conv3x3x3_cat_ndhwc",
                   "upsample2x_trilinear_ndhwc", "norm_apply_ndhwc",
                   "blend_scatter")


def dev_seg_model(torch, dev, pth, lr=SEG_LR, plain=False):
    """The dev backbone through the registry route (`hf_variant=
    "anatomix-dev"`, its seeded weights from the local `pth`: instance
    norm eps 1e-2, the published setting) and a fresh head, its Adam and
    train step on the CLI's schedule."""
    from anatomix_tpu_torch.segmentation.model import load_seg_model
    from anatomix_tpu_torch.segmentation.train import (
        build_seg_train_step,
        cosine_annealing,
        make_seg_optimizer,
    )

    plan, params = load_seg_model(SEG_CLASSES, hf_variant="anatomix-dev",
                                  cache_path=pth, device=dev)
    step = build_seg_train_step(
        plan, make_seg_optimizer(params, lr),
        cosine_annealing(lr, SEG_EPOCHS, SEG_ITERS), plain=plain)
    return plan, params, step


def run_dev_segmentation(torch, dev, wrappers, paths, pth, root):
    """`[dev-segmentation]`: few-shot finetuning of the 94M dev backbone at
    the CLI's defaults (crop 128^3, batch 3, Adam 2e-4, DiceCE) on the
    seeded 192^3 subjects: `dev_segmentation_val_seconds_256` (one
    `validate` of the 256^3 volume, 125 windows in 32 chunks of 4: K1, D1,
    D2, D3, K4), then DEV_SEG_STEPS steps on the kernels (the general
    train walk), `dev_segmentation_step_seconds_128crop` the median of
    steps 2+ on the host clock between synchronizes, CUDA events and the
    wait for the batch beside it, the peak of the first step. Gate: the
    first four batches stepped from the same state on the f32 plain route
    and on it with bf16-rounded images: the first loss within 1e-2, each
    of the four within 2.5x the plain route's spread + 1e-3; the
    validation logits after the steps at DEV_SEG_GATE_SIZE^3 (the fused
    forward on the split against the plain route on the same parameters)
    to the two-part rule."""
    import numpy as np

    from anatomix_tpu_torch.ops.sliding_window import compute_window_starts
    from anatomix_tpu_torch.segmentation.data import (
        VolumeCache,
        data_handler,
    )
    from anatomix_tpu_torch.segmentation.train import load_batch, validate
    from anatomix_tpu_torch.segmentation.transforms import val_transform

    tri, trs, vai, vas = data_handler(root, 3, DEV_SEG_STEPS, SEG_BATCH)
    cache = VolumeCache(dev)
    for p in tri[:3] + trs[:3] + vai + vas:
        cache.get(p)
    val_vol = val_transform(cache.get(vai[0]))
    order = np.random.default_rng(0).permutation(len(tri))
    gen = torch.Generator().manual_seed(0)
    field_gen = torch.Generator(device=dev).manual_seed(0)
    plan, params, step = dev_seg_model(torch, dev, pth)
    if plan.config.norm_eps != 1e-2:
        raise RuntimeError(f"dev-segmentation: eps {plan.config.norm_eps}")
    n_conv = len(plan.conv_indices)
    want = {k: 0 for k in wrappers}
    want.update({"conv3x3x3_ndhwc": n_conv, "conv3x3x3_wgrad_ndhwc": n_conv,
                 "conv3x3x3_dgrad_ndhwc": n_conv - 1,
                 "pad_shell_ndhwc": n_conv - 1})

    def val_timed(tag):
        reset_counts(wrappers)
        dl, sec = timed(torch, lambda: validate(
            plan, params, vai, vas, cache, SEG_CROP, SEG_CLASSES,
            plain=False))
        c = paths[tag] = counts(wrappers)
        off = [k for k in wrappers if (c[k] > 0) != (k in DEV_VAL_KERNELS)]
        if off:
            raise RuntimeError(f"dev-segmentation: validation launches {c}")
        return dl, sec

    val_before, val_before_s = val_timed("dev_segmentation_val_256")
    n_win = len(compute_window_starts((SEG_VAL_SIZE,) * 3, (SEG_CROP,) * 3,
                                      0.7))

    batches, losses, host_s, dev_ms, data_s, per_step = [], [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    for i in range(DEV_SEG_STEPS):
        idxs = order[i * SEG_BATCH:(i + 1) * SEG_BATCH]
        batch, t_data = timed(torch, lambda: load_batch(
            cache, tri, trs, idxs, SEG_CROP, gen, field_gen))
        if i < SEG_GATE_STEPS:
            batches.append(batch)
        before = counts(wrappers)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        loss = step(params, *batch)
        ev1.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        dev_ms.append(ev0.elapsed_time(ev1))
        data_s.append(t_data)
        losses.append(float(loss))
        per_step.append({k: v - before[k] for k, v in counts(wrappers).items()})
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    paths["dev_segmentation_train"] = counts(wrappers)
    val_after, val_after_s = val_timed("dev_segmentation_val_256_after")
    bad = [i + 1 for i, c in enumerate(per_step) if c != want]
    if bad:
        raise RuntimeError(f"dev-segmentation: launches of step {bad[0]} "
                           f"{per_step[bad[0] - 1]}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"dev-segmentation: non-finite loss {losses}")
    res = dict(
        dev_segmentation_step_seconds_128crop=statistics.median(host_s[1:]),
        dev_segmentation_val_seconds_256=val_after_s,
        val_before_training_s=val_before_s, step_device_ms=dev_ms,
        step_host_s=host_s, data_s=data_s, losses=losses, peak_gib=peak,
        launches_per_step=per_step[0],
        val_launches=paths["dev_segmentation_val_256_after"], windows=n_win,
        val_dice_loss=dict(kernels_before=val_before,
                           kernels_after=val_after))
    log(f"[dev-segmentation] 94M dev UNet (hf_variant anatomix-dev, eps "
        f"{plan.config.norm_eps}), {SEG_CLASSES} classes, crop {SEG_CROP}^3 "
        f"x batch {SEG_BATCH}, Adam {SEG_LR}, {DEV_SEG_STEPS} steps: "
        f"dev_segmentation_step_seconds_128crop "
        f"{res['dev_segmentation_step_seconds_128crop']:.4f} (median of "
        f"steps 2+, host clock); CUDA events median "
        f"{statistics.median(dev_ms[1:]):.4f} ms; wait for the batch "
        f"median {1e3 * statistics.median(data_s[1:]):.4f} ms; peak "
        f"{peak:.2f} GiB (the first step); launches per step {per_step[0]}; "
        f"{nvidia_smi()}")
    log(f"[dev-segmentation] dev_segmentation_val_seconds_256 "
        f"{val_after_s:.4f} (before training {val_before_s:.4f}; {n_win} "
        f"windows, roi {SEG_CROP}, overlap 0.7, constant; launches "
        f"{res['val_launches']}); val Dice loss {val_before:.4f} -> "
        f"{val_after:.4f}")
    log(f"[dev-segmentation] losses {['%.4f' % v for v in losses]}")

    # the gate: the plain routes on the first batches, from the same state
    _, pparams, pstep = dev_seg_model(torch, dev, pth, plain=True)
    plain = [float(pstep(pparams, *b)) for b in batches]
    del pparams, pstep
    _, qparams, qstep = dev_seg_model(torch, dev, pth, plain=True)
    spread = [float(qstep(qparams, b[0].to(torch.bfloat16).float(), b[1]))
              for b in batches]
    del qparams, qstep, batches
    torch.cuda.empty_cache()
    rel_k = [abs(k - p) / abs(p) for k, p in zip(losses, plain)]
    rel_q = [abs(q - p) / abs(p) for q, p in zip(spread, plain)]
    bound_q = [TOL_VS_BF16_PLAIN * q + TOL_VS_BF16_PLAIN_ABS for q in rel_q]
    # the validation logits after the steps, on the same parameters, at the
    # smaller size: the fused forward, the plain f32 route, the plain route
    # in bf16
    G = DEV_SEG_GATE_SIZE
    vol = val_vol[:G, :G, :G].contiguous()
    routes = {"kernels": seg_val_logits(torch, plan, params, vol),
              "plain": seg_val_logits(torch, plan, params, vol, True)}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        routes["plain_bf16"] = seg_val_logits(torch, plan, params, vol, True)
    e = {r: model_err(routes[r], routes["plain"])
         for r in ("kernels", "plain_bf16")}
    del routes
    log(f"[dev-segmentation] gate: first loss {losses[0]:.6f} vs the plain "
        f"f32 route {plain[0]:.6f}: rel {rel_k[0]:.3e} (tol "
        f"{TOL_TRAIN_LOSS}); losses of steps 1-{SEG_GATE_STEPS}: kernels "
        f"{losses[:SEG_GATE_STEPS]}, plain f32 {plain}, plain f32 on bf16 "
        f"images {spread}; |kernels - plain| / |plain| "
        f"{['%.3e' % v for v in rel_k[:SEG_GATE_STEPS]]} vs bound "
        f"{['%.3e' % v for v in bound_q]}")
    log(f"[dev-segmentation] gate: validation logits at {G}^3 after "
        f"{DEV_SEG_STEPS} steps, same parameters, vs the plain f32 route, "
        f"mean|err|/std (max/max): fused kernels "
        f"{e['kernels']['mean_err_over_std']:.4e} "
        f"({e['kernels']['max_err_over_max']:.3e}), the plain route in bf16 "
        f"{e['plain_bf16']['mean_err_over_std']:.4e} (tol {TOL_MODEL} and "
        f"{TOL_VS_BF16_PLAIN}x plain bf16 + {TOL_VS_BF16_PLAIN_ABS})")
    if not rel_k[0] < TOL_TRAIN_LOSS:
        raise RuntimeError(f"dev-segmentation: first loss {losses[0]} vs "
                           f"{plain[0]}")
    bad = [i + 1 for i, (r, b) in enumerate(zip(rel_k, bound_q))
           if not r <= b]
    if bad:
        raise RuntimeError(f"dev-segmentation: steps {bad} outside the "
                           f"bound: {rel_k[:SEG_GATE_STEPS]} vs {bound_q}")
    two_part_gate("dev-segmentation validation logits",
                  e["kernels"]["mean_err_over_std"],
                  e["plain_bf16"]["mean_err_over_std"])
    res["gate"] = dict(plain_losses=plain, plain_bf16_losses=spread,
                       rel_err=rel_k[:SEG_GATE_STEPS], bound=bound_q,
                       val_logits=e, val_logits_size=G)
    del params, cache
    torch.cuda.empty_cache()
    return res


def profile_dev_segmentation(torch, dev, out_dir):
    """`profile_segmentation` of the dev backbone (its seeded weights as a
    local `anatomix-dev.pth`, the `hf_variant` route) on the seeded NIfTI
    dataset, in a temporary directory."""
    import tempfile

    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

    dplan = build_plan(UnetConfig(
        **ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]))
    with tempfile.TemporaryDirectory() as tmp:
        pth = seeded_pth(torch, dplan, os.path.join(tmp, "anatomix-dev.pth"))
        return profile_segmentation(
            torch, dev, out_dir, pth, seg_dataset(os.path.join(tmp, "data")),
            tag="dev_", model=dev_seg_model)


def run_segmentation_phases(torch, dev, wrappers, paths, kt, plan, *,
                            six_m=True, dev_backbone=True):
    """Phase 11 in a temporary directory: the NIfTI dataset, then with
    `six_m` the 6M UNet's seeded weights as a `.pth`, `[segmentation]`,
    `[segmentation-gate]` and `[segmentation-cli]`; with `dev_backbone`
    the 94M dev UNet's seeded weights as a local `anatomix-dev` `.pth`,
    `[dev-segmentation]` and `[dev-segmentation-cli]` (the CLI with
    `--hf_variant anatomix-dev`). Returns the phases' results by name."""
    import tempfile

    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = seg_dataset(os.path.join(tmp, "data"))
        log(f"[segmentation] wrote the NIfTI dataset in "
            f"{time.perf_counter() - t0:.2f} s")
        if six_m:
            ckpt = seeded_pth(torch, plan,
                              os.path.join(tmp, "anatomix_seed0.pth"))
            out["segmentation"] = run_segmentation(
                torch, dev, wrappers, paths, kt, ckpt, root)
            out["segmentation_cli"] = run_segmentation_cli(
                torch, dev, wrappers, paths, ["--pretrained_ckpt", ckpt],
                root)
        if dev_backbone:
            dplan = build_plan(UnetConfig(
                **ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]))
            pth = seeded_pth(torch, dplan,
                             os.path.join(tmp, "anatomix-dev.pth"))
            out["dev_segmentation"] = run_dev_segmentation(
                torch, dev, wrappers, paths, pth, root)
            out["dev_segmentation_cli"] = run_segmentation_cli(
                torch, dev, wrappers, paths,
                ["--hf_variant", "anatomix-dev", "--cache_path", pth], root,
                tag="dev-segmentation-cli", epochs=1,
                expect=("conv3x3x3_ndhwc", "conv3x3x3_wgrad_ndhwc",
                        "conv3x3x3_dgrad_ndhwc", "pad_shell_ndhwc")
                + DEV_VAL_KERNELS)
    return out


def profile_segmentation(torch, dev, out_dir, ckpt, root, *, tag="",
                         model=None):
    """One segmentation step (its batch read and transformed first) and one
    256^3 validation under torch.profiler: each one's device busy share
    and top device operations, and host time by `seg/*` range. `model`
    builds the backbone from `ckpt` (default the 6M UNet's `seg_model`;
    the dev backbone's `dev_seg_model`), `tag` names its files."""
    import numpy as np

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anatomix_tpu_torch.segmentation.data import (
        VolumeCache,
        data_handler,
    )
    from anatomix_tpu_torch.segmentation.train import load_batch, validate
    from anatomix_tpu_torch.utils.profiling import annotate

    tri, trs, vai, vas = data_handler(root, 3, 4, SEG_BATCH)
    cache = VolumeCache(dev)
    plan, params, step = (model or seg_model)(torch, dev, ckpt)
    gen = torch.Generator().manual_seed(0)
    field_gen = torch.Generator(device=dev).manual_seed(0)
    order = np.random.default_rng(0).permutation(len(tri))

    def one_step(i):
        idxs = order[i * SEG_BATCH:(i + 1) * SEG_BATCH]
        with annotate("seg/data"):
            batch = load_batch(cache, tri, trs, idxs, SEG_CROP, gen,
                               field_gen)
        with annotate("seg/step"):
            float(step(params, *batch))

    def one_val():
        with annotate("seg/val"):
            validate(plan, params, vai, vas, cache, SEG_CROP, SEG_CLASSES)

    one_step(0)
    one_val()
    torch.cuda.synchronize()
    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for what, fn in (("step", lambda: one_step(1)), ("val", one_val)):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
        rows = sorted(((getattr(ev, attr) / 1e3, ev.count, ev.key)
                       for ev in events if is_device_work(ev)
                       and getattr(ev, attr) > 0), reverse=True)
        busy_ms = sum(r[0] for r in rows)
        ranges = sorted(((ev.cpu_time_total / 1e3, ev.count, ev.key)
                         for ev in events if ev.key.startswith("seg/")
                         and ev.device_type == DeviceType.CPU), reverse=True)
        name = f"{tag}segmentation_{what}"
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(events.table(sort_by=attr, row_limit=60))
        log(f"[profile] {name}: wall {wall_ms:.2f} ms, device "
            f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
        for ms, count, key in rows[:16]:
            log(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
        for ms, count, key in ranges:
            log(f"[profile]   {ms:9.3f} ms host  {count:3d}x  {key}")
        out[what] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                         top=[dict(ms=r[0], count=r[1], name=r[2])
                              for r in rows[:20]],
                         ranges=[dict(ms=m, count=c, name=k)
                                 for m, c, k in ranges])
    del params, cache
    torch.cuda.empty_cache()
    return out


# -----------------------------------------------------------------------------
# the parallel paths (one process group of the cards this machine has; one
# card here gives a world of one, NCCL all the same)

# [parallel-dev-full] against the unsharded forward: the same kernels on
# the same planes (the halo planes are the planes the unsharded conv reads
# through its padding), so any difference is of summation order
TOL_SHARDED_VS_FULL = 1e-3


def step_pair(torch, dev, wrappers, cfg, mesh, n_steps=3) -> dict:
    """`[parallel-step]` for one config: `n_steps` unsharded steps of
    `build_all(cfg)`'s step from its seeded state on `[train-step128]`'s
    batch (the sampler at seed 7 each step), keeping the state before
    each; then from each of those states one step through
    `build_train_step(mesh=...)`. A step's loss is computed before its
    update, so each pair reads the same state and must agree bit for bit;
    the pairs start from one state rather than running free, which also
    keeps the dev step's trilinear backward (torch's, with atomics) from
    moving the series apart."""
    from anatomix_tpu_torch.parallel.mesh import shard_batch
    from anatomix_tpu_torch.pretraining.train import build_all

    _, _, state, step = build_all(cfg, 1000, device=dev)
    _, _, _, mstep = build_all(cfg, 1000, device=dev, mesh=mesh)
    views, segs = train_batch(torch, dev, cfg.crop_size)
    mviews, msegs = shard_batch(mesh, views), shard_batch(mesh, segs)
    out = {k: [] for k in ("losses", "mesh_losses", "ms", "mesh_ms")}
    for _ in range(n_steps):
        for key, fn, v, s in (("", step, views, segs),
                              ("mesh_", mstep, mviews, msegs)):
            reset_counts(wrappers)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            new, metrics = fn(state, v, s,
                              torch.Generator(device=dev).manual_seed(7))
            end.record()
            torch.cuda.synchronize()
            out[f"{key}launches"] = counts(wrappers)
            out[f"{key}ms"].append(start.elapsed_time(end))
            out[f"{key}losses"].append(float(metrics["loss"]))
            if key == "":
                unsharded_next = new
            del new
        state = unsharded_next
    del state, unsharded_next
    torch.cuda.empty_cache()
    return out


def run_parallel(torch, dev, mfe, wrappers, paths, plan, sd, vol256,
                 report, init_params, dplan):
    """The parallel phases: `[parallel-full]` (the 6M UNet's 256^3 `full`
    through the 'space' route: a halo exchange and K1 in its D-valid mode
    for every conv, against `full` on the same volume and the f32 plain
    path), `[parallel-dev-full]` (the dev UNet's 128^3 `full` through it:
    the sharded instance norm and the trilinear halo, against the
    unsharded `full`), `[parallel-step]` (the 6M and the dev pretraining
    steps through `build_train_step(mesh=...)`, their first three losses
    against the unsharded steps'), then `[parallel]`: the dry run on
    min(4, cards) ranks, one card each, on NCCL, and its trainer phase."""
    import torch.distributed as dist

    from anatomix_tpu_torch.parallel import dryrun
    from anatomix_tpu_torch.parallel.launch import free_port, init_local_group
    from anatomix_tpu_torch.parallel.mesh import data_mesh, space_mesh

    out = {}
    init_local_group(0, 1, "cuda", free_port())
    try:
        smesh = space_mesh(1, 1, device=dev)
        n_conv = len(plan.conv_indices)

        # [parallel-full]: the 6M `full` on 256^3 through the space route
        full = mfe(plan, sd, strategy="full", device=dev)
        sharded = mfe(plan, sd, strategy="full", device=dev, mesh=smesh)
        sharded(vol256[:, :32, :32, :32])
        reset_counts(wrappers)
        feats, _ = timed(torch, lambda: sharded(vol256))
        c = paths["parallel_full_256"] = counts(wrappers)
        check_path("parallel-full", feats, (1, 256, 256, 256, 16), c,
                   ["conv3x3x3_dvalid_ndhwc"])
        if (c["conv3x3x3_dvalid_ndhwc"] != n_conv
                or c["conv3x3x3_ndhwc"] or c["conv3x3x3_upcat_ndhwc"]):
            raise RuntimeError(f"parallel-full: launches {c}, want "
                               f"{n_conv} D-valid convs and no other")
        # the two routes in turns: full, sharded, sharded, full, ...
        t_full, t_sp = [], []
        for _ in range(3):
            t_full.append(timed(torch, lambda: full(vol256))[1])
            t_sp.append(timed(torch, lambda: sharded(vol256))[1])
        ref_full = full(vol256)
        eager = mfe(plan, sd, strategy="full", impl="eager", device=dev)
        ref = eager(vol256)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            e_plain_bf16 = mean_rel(eager(vol256), ref)
        e = model_err(feats, ref)
        d = model_err(feats, ref_full)
        log(f"[parallel-full] 256^3 space route (world 1): median "
            f"{statistics.median(t_sp):.4f} s {t_sp} beside `full` "
            f"{statistics.median(t_full):.4f} s {t_full}; launches {c}")
        log(f"[parallel-full] vs `full`: max_abs_err {d['max_abs_err']:.3e}"
            f", mean|err|/std {d['mean_err_over_std']:.3e}; vs the f32 "
            f"plain path {e['mean_err_over_std']:.3e} (`full` "
            f"{mean_rel(ref_full, ref):.3e}, the plain path in bf16 "
            f"{e_plain_bf16:.3e})")
        two_part_gate("parallel-full", e["mean_err_over_std"], e_plain_bf16)
        out["full"] = dict(seconds=t_sp, full_seconds=t_full, launches=c,
                           vs_full=d, vs_plain=e, plain_bf16=e_plain_bf16)
        del feats, ref_full, ref, full, sharded, eager
        torch.cuda.empty_cache()

        # [parallel-dev-full]: the dev UNet at 128^3 through the space route
        dsd = {k: v.to(dev) for k, v in
               init_params(dplan, torch.Generator().manual_seed(0)).items()}
        vol128 = vol256[:, :128, :128, :128].contiguous()
        dfull = mfe(dplan, dsd, strategy="full", device=dev)
        dsharded = mfe(dplan, dsd, strategy="full", device=dev, mesh=smesh)
        ref = dfull(vol128)
        dsharded(vol128)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        y = dsharded(vol128)
        torch.cuda.synchronize()
        c = paths["parallel_dev_full_128"] = counts(wrappers)
        check_path("parallel-dev-full", y, (1, 128, 128, 128, 32), c,
                   ["conv3x3x3_dvalid_ndhwc", "norm_apply_ndhwc",
                    "upsample2x_trilinear_ndhwc"])
        if c["conv3x3x3_ndhwc"] or c["conv3x3x3_cat_ndhwc"]:
            raise RuntimeError(f"parallel-dev-full: launches {c}")
        ms = cuda_ms(lambda: dsharded(vol128))
        full_ms = cuda_ms(lambda: dfull(vol128))
        d = model_err(y, ref)
        log(f"[parallel-dev-full] 94M 128^3 space route (world 1): "
            f"{ms:.4f} ms beside `full` {full_ms:.4f} ms; vs `full` "
            f"max_abs_err {d['max_abs_err']:.3e}, mean|err|/std "
            f"{d['mean_err_over_std']:.3e} (tol {TOL_SHARDED_VS_FULL}); "
            f"launches {c}")
        if not d["mean_err_over_std"] < TOL_SHARDED_VS_FULL:
            raise RuntimeError(f"parallel-dev-full: {d}")
        out["dev_full"] = dict(ms=ms, full_ms=full_ms, launches=c,
                               vs_full=d)
        del y, ref, dfull, dsharded, dsd
        torch.cuda.empty_cache()

        # [parallel-step]: the steps through build_train_step(mesh=...)
        from anatomix_tpu_torch.pretraining.config import PretrainConfig

        dmesh = data_mesh(1, device=dev)
        for name, cfg, key in (("6M", PretrainConfig(), "train"),
                               ("dev", dev_pretrain_config(), "dev_train")):
            r = step_pair(torch, dev, wrappers, cfg, dmesh)
            c = paths[f"parallel_step_{name}"] = r["mesh_launches"]
            bit = [a == b for a, b in zip(r["mesh_losses"], r["losses"])]
            log(f"[parallel-step] {name}: losses through the mesh "
                f"{r['mesh_losses']}, unsharded from the same states "
                f"{r['losses']}: bit-equal {bit}; step ms {r['mesh_ms']} "
                f"beside {r['ms']}; launches per step {c}")
            if key in report:  # the earlier phase, free-running
                ref = report[key]["losses"][:3]
                log(f"[parallel-step] {name}: `[{key.replace('_', '-')}"
                    f"-step128]` read {ref} (rel "
                    f"{[abs(a - b) / abs(b) for a, b in zip(r['losses'], ref)]}"
                    f" from the unsharded steps here)")
                if r["losses"][0] != ref[0]:
                    raise RuntimeError(f"parallel-step {name}: first loss "
                                       f"{r['losses'][0]} vs {ref[0]}")
            if not all(bit) or c != r["launches"]:
                raise RuntimeError(f"parallel-step {name}: {r}")
            out[f"step_{name}"] = dict(r, bit_equal=bit)
    finally:
        dist.destroy_process_group()

    # [parallel]: the dry run, one rank per card (not this process's group)
    n = min(4, torch.cuda.device_count())
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun(n, "cuda", with_train=True)
    out["dryrun"]["seconds"] = time.perf_counter() - t0
    log(f"[parallel] dryrun over {n} ranks on NCCL: {out['dryrun']}")
    return out


def run_conv_time(torch, kc, kt, dev, rounds: int = 4) -> dict:
    """The reflect-padded convs alone, by CUDA events in `rounds` rounds:
    T-w at the dev step's 128^3 96 -> 32 and at the 6M step's 128^3 16 ->
    16, K1 and T-x at the latter (B2): the numbers that decide whether the
    ordered T-w reduction is the only path and what the pad modes cost the
    default route. It reads only the wrappers, so a copy of this script
    measures an earlier checkout the same way."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for ci, co in ((96, 32), (16, 16)):
        x = torch.randn((2, 128, 128, 128, ci), generator=gen,
                        device=dev).to(torch.bfloat16)
        dy = torch.randn((2, 128, 128, 128, co), generator=gen,
                         device=dev).to(torch.bfloat16)
        w = (torch.randn((27 * ci, co), generator=gen, device=dev)
             * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
        b = torch.zeros((co,), device=dev)
        fns = {"wgrad": lambda: kt.conv3x3x3_wgrad_ndhwc(
            x, dy, pad_type="reflect")}
        if ci == 16:
            fns["conv"] = lambda: kc.conv3x3x3_ndhwc(
                x, w, b, act="relu", pad_type="reflect")
            fns["dgrad"] = lambda: kt.conv3x3x3_dgrad_ndhwc(
                dy, w, pad_type="reflect")
        for name, fn in fns.items():
            out[f"{name} B2 128^3 {ci}->{co}"] = [cuda_ms(fn)
                                                  for _ in range(rounds)]
        del x, dy
    log(f"[conv-time] {out}; {nvidia_smi()}")
    return out


# -----------------------------------------------------------------------------
# phase 14: every UNet option of the JAX package (PReLU, SELU, residual
# connections, replicate and circular padding, 1-D and 2-D nets) and the
# ordered T-w (P5)

def torch_pad(F, xc, pad):
    """`xc` (B, C, D, H, W) padded by 1 on each axis with that axis's mode
    of `pad` (one name or one per axis; the JAX package's `jnp.pad`
    modes under torch's names)."""
    modes = (pad,) * 3 if isinstance(pad, str) else tuple(pad)
    for ax, m in enumerate(modes):
        w = [0] * 6
        w[2 * (2 - ax):2 * (2 - ax) + 2] = [1, 1]
        xc = F.pad(xc, w, mode="constant" if m == "zeros" else m)
    return xc


def pad_name(pad) -> str:
    return pad if isinstance(pad, str) else "/".join(pad)


def check_conv_mode(kc, torch, F, dev, gen, B, spatial, ci, co, pad,
                    act="relu", out_f32=False, slope=0.3):
    """conv3x3x3_ndhwc at (B, D, H, W, ci) -> co with padding `pad` (a
    mode per axis where a lifted net's axes pad with zeros) and epilogue
    `act`, against its plain version; cuDNN (bf16, channels-last) on the
    input padded beforehand (the pad not timed) as the yardstick."""
    D, H, W = spatial
    x = torch.randn((B, D, H, W, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    kw = dict(act=act, slope=slope, pad_type=pad, out_dtype=out_dtype)
    got = kc.conv3x3x3_ndhwc(x, w, b, **kw)
    ref = kc.conv3x3x3_ndhwc_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    tol = tol_conv_f32(27 * ci) if out_f32 else TOL_CONV_BF16
    ms = cuda_ms(lambda: kc.conv3x3x3_ndhwc(x, w, b, **kw))
    plain_ms = cuda_ms(lambda: kc.conv3x3x3_ndhwc_plain(x, w, b, **kw))
    xc = torch_pad(F, x.permute(0, 4, 1, 2, 3), pad).contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * D * H * W
    # the function's own work: a lifted axis (extent 1, zero padded) leaves
    # one live tap of its three (the kernel still multiplies all 27: the
    # lifted-axis MMAs, item 16's work)
    flops = 2.0 * vox * 3 ** sum(s > 1 for s in spatial) * ci * co
    nbytes = vox * ci * 2 + 27 * ci * co * 2 + co * 4 + vox * co * (
        4 if out_f32 else 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        shape=f"B{B} {D}x{H}x{W} {ci}->{co} {pad_name(pad)} {act}"
        + (" f32-out" if out_f32 else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, spatial, ci, co)),
    )


def check_two_operand_mode(kc, torch, F, dev, gen, B, S, c1, c2, co, pad,
                           up):
    """K3 (`up`: the small operand at half resolution, nearest-upsampled
    in the kernel) or D3 (both at full resolution) under `pad`, relu,
    against the plain version; cuDNN over the materialized, padded concat
    (not timed) as the yardstick."""
    s = S // 2 if up else S
    enc = torch.randn((B, S, S, S, c1), generator=gen, device=dev).to(
        torch.bfloat16)
    small = torch.randn((B, s, s, s, c2), generator=gen, device=dev).to(
        torch.bfloat16)
    ci = c1 + c2
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = dict(act="relu", pad_type=pad)
    fn = kc.conv3x3x3_upcat_ndhwc if up else kc.conv3x3x3_cat_ndhwc
    plain = (kc.conv3x3x3_upcat_ndhwc_plain if up
             else kc.conv3x3x3_cat_ndhwc_plain)
    got = fn(enc, small, w, b, **kw)
    ref = plain(enc, small, w, b, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    ms = cuda_ms(lambda: fn(enc, small, w, b, **kw))
    plain_ms = cuda_ms(lambda: plain(enc, small, w, b, **kw))
    big = small
    if up:
        for ax in (1, 2, 3):
            big = torch.repeat_interleave(big, 2, dim=ax)
    cat = torch.cat([enc, big], dim=-1).permute(0, 4, 1, 2, 3)
    xc = torch_pad(F, cat, pad).contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = cuda_ms(lambda: F.conv3d(xc, wt, b.to(torch.bfloat16)))
    vox = B * S ** 3
    nbytes = (vox * c1 * 2 + B * s ** 3 * c2 * 2 + 27 * ci * co * 2 + co * 4
              + vox * co * 2)
    b_ms, b_by = bound(2.0 * vox * 27 * ci * co, nbytes)
    return dict(
        shape=f"B{B} {S}^3 [{c1}+{'up(' if up else ''}{c2}"
        f"{')' if up else ''}]->{co} {pad}",
        max_abs_err=err, rel_err=rel, tol=TOL_CONV_BF16,
        ok=rel < TOL_CONV_BF16, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by,
        plan=conv_plan_desc(kc.conv_plan(B, (S, S, S), ci, co)),
    )


def check_backward_mode(kt, torch, F, dev, gen, B, S, ci, co, which, pad):
    """T-w (dW f32) or T-x (dx bf16: the split store, then the shell pass)
    under `pad` at (B, S^3): ci -> co, against the plain version, with
    cuDNN's backward on the padded input as the yardstick; T-x also on its
    shell alone (the voxels the pad's adjoint sums into); both run twice
    on the same tensors, which must give the same bits (P5: T-w sums its
    split partials in order)."""
    x = torch.randn((B, S, S, S, ci), generator=gen, device=dev).to(
        torch.bfloat16)
    dy = torch.randn((B, S, S, S, co), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * ci, co), generator=gen, device=dev)
         * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
    if which == "wgrad":
        fn = lambda: kt.conv3x3x3_wgrad_ndhwc(x, dy, pad_type=pad)  # noqa
        plain = lambda: kt.conv3x3x3_wgrad_ndhwc_plain(  # noqa: E731
            x, dy, pad_type=pad)
        mask, tol = (False, True, False), TOL_WGRAD
        nbytes = B * S ** 3 * (ci + co) * 2 + 27 * ci * co * 4
        plan = wgrad_plan_desc(kt.wgrad_plan(B, (S, S, S), ci, co), ci)
    else:
        fn = lambda: kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)  # noqa
        plain = lambda: kt.conv3x3x3_dgrad_ndhwc_plain(  # noqa: E731
            dy, w, pad_type=pad)
        mask, tol = (True, False, False), TOL_CONV_BF16
        nbytes = B * S ** 3 * (ci + co) * 2 + 27 * ci * co * 2
        plan = conv_plan_desc(kt.conv_plan(B, (S + 2,) * 3, co, ci))
    got = fn()
    again = fn()
    ref = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    xc = torch_pad(F, x.permute(0, 4, 1, 2, 3), pad).contiguous(
        memory_format=torch.channels_last_3d)
    wt = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    dyc = dy.permute(0, 4, 1, 2, 3)
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dyc, xc, wt, None, [1] * 3, [0] * 3, [1, 1, 1], False, [0, 0, 0],
        1, list(mask))
    b_ms, b_by = bound(2.0 * B * S ** 3 * 27 * ci * co, nbytes)
    row = dict(
        shape=f"B{B} {S}^3 {ci}->{co} {pad}", max_abs_err=err, rel_err=rel,
        tol=tol, ok=rel < tol, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by, plan=plan,
        repeat_max_abs_diff=(got.float() - again.float()).abs().max()
        .item())
    if which == "dgrad":
        st, g_ext = kt.pad_dgrad_store(dy, w, pad)
        row.update(
            shell_rel_err=shell_rel_err(torch, got, ref),
            conv_ms=cuda_ms(lambda: kt.pad_dgrad_store(dy, w, pad)),
            fold_ms=cuda_ms(lambda: kt.pad_shell_ndhwc(g_ext, st, pad)),
            fold_library_ms=cuda_ms(fold_library(
                torch, torch.randn_like(g_ext))))
        row["ok"] = row["ok"] and row["shell_rel_err"] < tol
    row["ok"] = row["ok"] and row["repeat_max_abs_diff"] == 0.0
    return row


def check_norm_apply_mode(kn, norms, torch, dev, gen, B, S, C, act,
                          post_res, split):
    """D1 with the SELU epilogue or the residual block's post-activation
    `+ 0.1 x` (relu), the instance statistics of the f32 input, split
    and not, against the plain version."""
    from anatomix_tpu_torch.ops.conv import merge3

    x = torch.randn((B, S, S, S, C), generator=gen, device=dev)
    mean, var = norms.instance_norm_stats(x, (1, 1, 1))
    a, s = norms.fold_affine(mean, var, 1e-2)
    maps = norms.tile_maps(x.shape[1:4], (1, 1, 1), dev)
    kw = dict(act=act, split=split, post_res=post_res)
    got = kn.norm_apply_ndhwc(x, a, s, maps, **kw)
    ref = kn.norm_apply_ndhwc_plain(x, a, s, maps, **kw)
    torch.cuda.synchronize()
    err, rel = (rel_err(merge3(got), merge3(ref)) if split
                else rel_err(got, ref))
    tol = TOL_CONV_F32 if split else TOL_CONV_BF16
    n = x.numel()
    nbytes = (4.0 + (6.0 if split else 2.0)) * n + 8.0 * a.numel() + 4.0 * (
        sum(m.numel() for m in maps))
    b_ms, b_by = bound((5.0 if post_res else 3.0) * n, nbytes,
                       PEAK_F32_FLOPS)
    return dict(
        shape=f"B{B} {S}^3x{C} {act}" + (" +0.1x" if post_res else "")
        + (" split" if split else ""),
        max_abs_err=err, rel_err=rel, tol=tol, ok=rel < tol,
        ms=cuda_ms(lambda: kn.norm_apply_ndhwc(x, a, s, maps, **kw)),
        plain_ms=cuda_ms(lambda: kn.norm_apply_ndhwc_plain(x, a, s, maps,
                                                           **kw)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def options_kernel_checks(kc, kt, kn, norms, torch, F, dev) -> dict:
    """Phase 14's kernel rows: every new kernel mode at the options
    paths' shapes."""
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = {name: [] for name in (
        "conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc", "conv3x3x3_cat_ndhwc",
        "conv3x3x3_dgrad_ndhwc", "conv3x3x3_wgrad_ndhwc",
        "norm_apply_ndhwc")}
    lifted2 = ("zeros", "reflect", "reflect")
    for B, spatial, ci, co, pad, act, f32 in [
        (2, (128,) * 3, 16, 16, "replicate", "relu", False),
        (2, (128,) * 3, 16, 16, "circular", "relu", False),
        (2, (64,) * 3, 96, 32, "replicate", "none", True),
        (4, (1, 512, 512), 16, 16, lifted2, "relu", False),
        (2, (128,) * 3, 16, 16, "reflect", "selu", False),
    ]:
        rows["conv3x3x3_ndhwc"].append(check_conv_mode(
            kc, torch, F, dev, gen, B, spatial, ci, co, pad, act, f32))
    # PReLU: the lrelu epilogue with the weight's value as its slope
    rows["conv3x3x3_ndhwc"].append(check_conv_mode(
        kc, torch, F, dev, gen, 2, (128,) * 3, 16, 16, "replicate", "lrelu",
        slope=0.37))
    rows["conv3x3x3_upcat_ndhwc"].append(check_two_operand_mode(
        kc, torch, F, dev, gen, 2, 128, 16, 32, 16, "replicate", up=True))
    rows["conv3x3x3_cat_ndhwc"].append(check_two_operand_mode(
        kc, torch, F, dev, gen, 2, 32, 384, 768, 128, "replicate", up=False))
    for pad in ("replicate", "circular"):
        for which in ("dgrad", "wgrad"):
            rows[f"conv3x3x3_{which}_ndhwc"].append(check_backward_mode(
                kt, torch, F, dev, gen, 2, 128, 16, 16, which, pad))
    rows["conv3x3x3_wgrad_ndhwc"].append(check_backward_mode(
        kt, torch, F, dev, gen, 2, 128, 96, 32, "wgrad", "reflect"))
    for act, post_res in (("selu", False), ("relu", True)):
        for split in (False, True):
            rows["norm_apply_ndhwc"].append(check_norm_apply_mode(
                kn, norms, torch, dev, gen, 1, 128, 32, act, post_res,
                split))
    return rows


def seeded_bn_stats(torch, sd, seed=3):
    """Non-trivial running statistics for every batch norm of `sd`."""
    gen = torch.Generator().manual_seed(seed)
    for k, v in list(sd.items()):
        if k.endswith("running_mean"):
            sd[k] = (torch.randn(v.shape, generator=gen) * 0.1).to(v.device)
        elif k.endswith("running_var"):
            sd[k] = (0.5 + torch.rand(v.shape, generator=gen)).to(v.device)
    return sd


def slices_2d(torch, dev, n, size, seed, noisy):
    """`n` seeded 2-D images (n, size, size, 1) in [0, 1]: the 3-D test
    volumes' blobs (`synthetic_volume` with its noise when `noisy`, else
    `smooth_field`'s) evaluated on `n` planes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ax = torch.linspace(-1, 1, size, device=dev)
    zs = torch.linspace(-0.3, 0.3, n, device=dev)
    z, y, x = torch.meshgrid(zs, ax, ax, indexing="ij")
    img = torch.zeros((n, size, size), device=dev)
    centers = torch.rand((8, 3), generator=gen, device=dev) * 1.6 - 0.8
    widths = 0.05 + 0.2 * torch.rand((8,), generator=gen, device=dev)
    for c, s in zip(centers, widths):
        img += torch.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2
                           + (x - c[2]) ** 2) / s)
    if noisy:
        img += 0.05 * torch.randn(img.shape, generator=gen, device=dev)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return ((img - lo) / (hi - lo))[..., None].contiguous()


def options_forward(torch, make_feature_extractor, wrappers, paths, tag,
                    plan, sd, dev, volumes, shape, needed):
    """One options path through `make_feature_extractor(strategy="full")`:
    the wall and CUDA-event time and the launches per kernel on the first
    volume, then on each volume the error against the port's f32 plain
    path (the eager module) beside the plain path run in bf16 (bf16 convs
    under autocast), under the two-part rule."""
    fused = make_feature_extractor(plan, sd, strategy="full", device=dev)
    eager = make_feature_extractor(plan, sd, strategy="full", impl="eager",
                                   device=dev)
    first = next(iter(volumes.values()))
    fused(first)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    feats, wall_s = timed(torch, lambda: fused(first))
    c = paths[tag] = counts(wrappers)
    check_path(tag, feats, shape, c, needed)
    ms = cuda_ms(lambda: fused(first), min_ms=10.0, max_reps=5)
    log(f"[{tag}] {tuple(first.shape)} -> {tuple(feats.shape)}: wall "
        f"{wall_s:.4f} s, CUDA events {ms:.4f} ms, launches {c}")
    del feats
    out = dict(seconds=wall_s, ms=ms, launches=c)
    for name, vol in volumes.items():
        ref = eager(vol)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            ref_b = eager(vol)
        r = dict(kernels=mean_rel(fused(vol), ref),
                 plain_bf16=mean_rel(ref_b, ref))
        out[name] = r
        log(f"[{tag}] {name} vs the f32 plain path, mean|err|/std: kernels "
            f"{r['kernels']:.3e}, the plain path in bf16 "
            f"{r['plain_bf16']:.3e} (tol {TOL_MODEL} and "
            f"{TOL_VS_BF16_PLAIN}x plain bf16 + {TOL_VS_BF16_PLAIN_ABS})")
        two_part_gate(f"{tag} {name}", r["kernels"], r["plain_bf16"])
        del ref, ref_b
    del fused, eager
    torch.cuda.empty_cache()
    return out


def fold_every_batch_norm(plan, sd):
    """The JAX package's fold (ROADMAP F10): every batch norm into its
    conv, residual sources included."""
    import dataclasses

    from anatomix_tpu_torch.extract import fold_batchnorm

    plain_cfg = dataclasses.replace(plan.config, residual_connection=False)
    fplan, fsd = fold_batchnorm(dataclasses.replace(plan, config=plain_cfg),
                                sd)
    for i in plan.conv_indices:  # the exit conv keeps no bias
        w = fsd[f"model.{i}.weight"]
        fsd.setdefault(f"model.{i}.bias", w.new_zeros(w.shape[0]))
    return dataclasses.replace(fplan, config=plan.config), fsd


def options_step(torch, dev, wrappers, paths, kt, cfg, tag, n_steps,
                 built=None):
    """A pretraining step with the options in `cfg` (`build_all`'s, or
    `built` = (plan, taps, state, step)): `n_steps` steps from the seeded
    state on `[train-step128]`'s batch; the first loss against the f32
    plain path, every backward launch against its plain version on the
    step's tensors, each dW and the PReLU weight's gradient against the
    plain backward from the same forward (`train_dw_check`); then the
    first step twice from the seeded state, losses and parameters bit for
    bit (P5)."""
    from anatomix_tpu_torch.models.unet import prelu_key
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import NCEOptions

    plan, taps, state0, step = built or build_all(cfg, 1000, device=dev)
    views, segs = train_batch(torch, dev, cfg.crop_size)
    sampler = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa
    state, losses, step_ms = state0, [], []
    for i in range(n_steps):
        if i == 0:
            reset_counts(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, views, segs, sampler())
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            c = paths[tag] = counts(wrappers)
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    n_conv = len(plan.conv_indices)
    if c["conv3x3x3_ndhwc"] != n_conv or c["conv3x3x3_wgrad_ndhwc"] != \
            n_conv or c["pad_shell_ndhwc"] != n_conv - 1:
        raise RuntimeError(f"{tag}: launches {c}")
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise RuntimeError(f"{tag}: non-finite loss {losses}")
    pkey = prelu_key(plan)
    log(f"[{tag}] {plan.config}: losses {losses}; step ms {step_ms}; "
        f"launches per step {c}"
        + (f"; PReLU weight {float(state.params_g[pkey]):.6f} after "
           f"{n_steps} steps" if pkey else ""))
    del state
    kw = dict(tap_layers=taps, num_patches=cfg.num_patches,
              nce=NCEOptions(temperature=cfg.nce_T))
    main = train_dw_check(torch, kt, plan, state0, views, segs, sampler, kw)
    loss_rel = abs(losses[0] - main["loss_plain"]) / abs(main["loss_plain"])
    errs = main["launch_errs"]
    log(f"[{tag}] first loss {losses[0]:.6f} vs plain f32 path "
        f"{main['loss_plain']:.6f}: rel {loss_rel:.3e} (tol "
        f"{TOL_TRAIN_LOSS}); wgrad launches max rel {max(errs['wgrad']):.3e}"
        f" (tol {TOL_WGRAD}), dgrad {max(errs['dgrad']):.3e}, its shell "
        f"{max(errs['dgrad_shell']):.3e} (tol {TOL_CONV_BF16}); dW vs the "
        f"plain backward of the same forward: {fmt_dw(main['dw_backward'])}")
    out = dict(losses=losses, step_ms=step_ms, launches=c,
               loss_rel=loss_rel, first_step=main)
    bad = (not loss_rel < TOL_TRAIN_LOSS
           or not max(errs["wgrad"]) < TOL_WGRAD
           or not max(errs["dgrad"]) < TOL_CONV_BF16
           or not max(errs["dgrad_shell"]) < TOL_CONV_BF16
           or not max(main["dw_backward"].values()) < TOL_TRAIN_DW)
    if pkey:
        out["prelu_grad_rel"] = main["prelu_backward"]
        log(f"[{tag}] the PReLU weight's gradient vs the plain backward of "
            f"the same forward: rel {main['prelu_backward']:.3e} (tol "
            f"{TOL_TRAIN_DW})")
        bad = bad or not main["prelu_backward"] < TOL_TRAIN_DW
    if bad:
        raise RuntimeError(f"{tag}: outside its gates: loss {loss_rel}, "
                           f"launches {errs}, dW {main['dw_backward']}")
    # P5: one step twice from one state
    runs = [step(state0, views, segs, sampler()) for _ in range(2)]
    torch.cuda.synchronize()
    (s1, m1), (s2, m2) = runs
    diff = max((s1.params_g[k].float() - s2.params_g[k].float()).abs()
               .max().item() for k in s1.params_g)
    out["repeat"] = dict(loss_equal=float(m1["loss"]) == float(m2["loss"]),
                         params_g_max_abs_diff=diff)
    log(f"[{tag}] one step twice from one state: losses {float(m1['loss'])!r}"
        f" / {float(m2['loss'])!r}, params_g max|diff| {diff}")
    if not (out["repeat"]["loss_equal"] and diff == 0.0):
        raise RuntimeError(f"{tag}: the step does not repeat: {out['repeat']}")
    del runs, s1, s2, state0
    torch.cuda.empty_cache()
    return out


def dev_step_repeat(torch, dev):
    """The dev UNet's pretraining step (`dev_pretrain_config()`) twice from
    one seeded state: the loss and how far the parameters land apart.
    Ungated: torch's trilinear upsample backward accumulates with atomics
    on the card (`upsample_trilinear3d_backward`)."""
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = dev_pretrain_config()
    _, _, state0, step = build_all(cfg, 1000, device=dev)
    views, segs = train_batch(torch, dev, cfg.crop_size)
    runs = [step(state0, views, segs,
                 torch.Generator(device=dev).manual_seed(7))
            for _ in range(2)]
    torch.cuda.synchronize()
    (s1, m1), (s2, m2) = runs
    diffs = {k: (s1.params_g[k].float() - s2.params_g[k].float()).abs()
             .max().item() for k in s1.params_g}
    worst = max(diffs, key=diffs.get)
    out = dict(losses=[float(m1["loss"]), float(m2["loss"])],
               params_g_max_abs_diff=diffs[worst], worst_leaf=worst,
               leaves_that_differ=sum(v > 0 for v in diffs.values()),
               leaves=len(diffs))
    log(f"[options-dev-repeat] the dev step twice from one state: losses "
        f"{out['losses']}, params_g max|diff| {diffs[worst]:.3e} at {worst}, "
        f"{out['leaves_that_differ']} of {len(diffs)} leaves differ")
    del runs, s1, s2, state0
    torch.cuda.empty_cache()
    return out


def run_options(torch, dev, make_feature_extractor, wrappers, paths, kt):
    """Phase 14: the UNet options on the card at full width."""
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import (
        Unet,
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.pretraining.config import PretrainConfig

    out = {}
    # [options-full]: the anatomix topology with PReLU 0.37, replicate
    # padding and residual connections, batch norms with non-trivial
    # running statistics, `full` on 256^3
    cfg = UnetConfig(**dict(ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"],
                            activation="prelu", pad_type="replicate",
                            residual_connection=True))
    plan = build_plan(cfg)
    sd = seeded_bn_stats(torch, init_params(
        plan, torch.Generator().manual_seed(0)))
    for i, spec in enumerate(plan.layers):
        if spec.kind == "act":
            sd[f"model.{i}.weight"] = torch.full((1,), 0.37)
    sd = {k: v.to(dev) for k, v in sd.items()}
    vols = {"noisy": synthetic_volume(torch, dev, 256, seed=1),
            "smooth": smooth_field(torch, dev, 256, seed=3)[
                None, ..., None].contiguous()}
    out["full"] = options_forward(
        torch, make_feature_extractor, wrappers, paths, "options-full",
        plan, sd, dev, vols, (1, 256, 256, 256, cfg.output_nc),
        ["conv3x3x3_ndhwc", "conv3x3x3_upcat_ndhwc", "norm_apply_ndhwc"])
    # what the JAX package's folded extractor computes instead (F10)
    fplan, fsd = fold_every_batch_norm(plan, sd)
    with torch.no_grad():
        net = Unet.from_state_dict(plan, sd).to(dev)
        fnet = Unet.from_state_dict(fplan, fsd).to(dev)
        v = vols["noisy"][:, :128, :128, :128].contiguous()
        f10 = mean_rel(fnet(v), net(v))
    out["f10_folded_vs_network"] = f10
    log(f"[options-full] F10: the batch norms folded into residual-source "
        f"convs (the JAX package's extractor) vs the network, 128^3: "
        f"mean|err|/std {f10:.3e} (ungated)")
    del net, fnet, fsd, sd, vols
    torch.cuda.empty_cache()

    # [options-dev-fwd128]: the anatomix-dev topology with SELU, circular
    # padding and residual connections, 128^3 B1
    dcfg = UnetConfig(**dict(ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"],
                             activation="selu", pad_type="circular",
                             residual_connection=True))
    dplan = build_plan(dcfg)
    dsd = {k: v.to(dev) for k, v in init_params(
        dplan, torch.Generator().manual_seed(0)).items()}
    out["dev_fwd128"] = options_forward(
        torch, make_feature_extractor, wrappers, paths, "options-dev-fwd128",
        dplan, dsd, dev,
        {"noisy": synthetic_volume(torch, dev, 128, seed=4),
         "smooth": smooth_field(torch, dev, 128, seed=3)[
             None, ..., None].contiguous()},
        (1, 128, 128, 128, dcfg.output_nc),
        ["conv3x3x3_ndhwc", "conv3x3x3_cat_ndhwc", "norm_apply_ndhwc",
         "upsample2x_trilinear_ndhwc"])
    del dsd
    torch.cuda.empty_cache()

    # [options-2d]: the 6M widths as a 2-D UNet on B4 512^2 slices
    tcfg = UnetConfig(**dict(ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"],
                             dimension=2))
    tplan = build_plan(tcfg)
    tsd = {k: v.to(dev) for k, v in seeded_bn_stats(torch, init_params(
        tplan, torch.Generator().manual_seed(0))).items()}
    out["2d"] = options_forward(
        torch, make_feature_extractor, wrappers, paths, "options-2d", tplan,
        tsd, dev,
        {"noisy": slices_2d(torch, dev, 4, 512, 5, True),
         "smooth": slices_2d(torch, dev, 4, 512, 6, False)},
        (4, 512, 512, tcfg.output_nc),
        ["conv3x3x3_ndhwc", "conv3x3x3_cat_ndhwc"])
    del tsd
    torch.cuda.empty_cache()

    # [options-step]: the launcher's own `--actG prelu` on the 6M step, then
    # a general-walk step (batch norm, residual, replicate, SELU)
    out["step_prelu"] = options_step(
        torch, dev, wrappers, paths, kt, PretrainConfig(actG="prelu"),
        "options-step", 5)
    out["step_general"] = options_general_step(
        torch, dev, wrappers, paths, kt, PretrainConfig(actG="selu"))
    out["dev_repeat"] = dev_step_repeat(torch, dev)
    return out


def options_general_step(torch, dev, wrappers, paths, kt, cfg):
    """The general train walk's step at the 6M widths with batch norm,
    residual connections, replicate padding and `cfg.actG`: the launcher
    (`build_all`, as the JAX package's) takes no residual or padding
    option, so the step is built on that plan with `init_train_state` and
    `build_train_step` at `cfg`'s settings."""
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan
    from anatomix_tpu_torch.pretraining.train_step import (
        build_train_step,
        init_train_state,
    )

    plan = build_plan(UnetConfig(
        input_nc=cfg.input_nc, output_nc=cfg.output_nc,
        num_downs=cfg.num_downs, ngf=cfg.ngf, norm=cfg.normG,
        activation=cfg.actG, residual_connection=True,
        pad_type="replicate"))
    taps = cfg.tap_layers()
    state = init_train_state(
        plan, torch.Generator().manual_seed(cfg.seed), tap_layers=taps,
        netf_nc=cfg.netF_nc, n_mlps=cfg.n_mlps, device=dev)
    step = build_train_step(
        plan, tap_layers=taps, num_patches=cfg.num_patches,
        nce_temperature=cfg.nce_T, lr=cfg.lr, compute_dtype=torch.bfloat16)
    return options_step(torch, dev, wrappers, paths, kt, cfg,
                        "options-step-general", 3,
                        built=(plan, taps, state, step))

if __name__ == "__main__":
    rc = main(sys.argv[1:])
    if rc == 0 and not sys.argv[1:]:
        import torch

        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    sys.exit(rc)
