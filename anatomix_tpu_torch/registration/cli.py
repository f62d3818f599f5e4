"""Registration CLI of the port, with the flags of
`anatomix_tpu.registration.cli` (the reference's
`run_convex_adam_with_network_feats.py`), plus `--cache_path` (the local
file of `--hf_variant`: the port downloads nothing) and `--device`
(default `cuda`).

Usage:
  python -m anatomix_tpu_torch.registration.cli --fixed f.nii.gz \
      --moving m.nii.gz --exp_name demo --ckpt_path anatomix.pth \
      [--use_mask --path_mask_fixed fm.nii.gz --path_mask_moving mm.nii.gz] \
      [--warp_seg --path_seg_fixed fs.nii.gz --path_seg_moving ms.nii.gz]
"""

from __future__ import annotations

import argparse

from anatomix_tpu_torch.registration.pipeline import convex_adam


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run ConvexAdam optimization with anatomix network feats."
    )
    parser.add_argument("--fixed", type=str, required=True)
    parser.add_argument("--moving", type=str, required=True)
    parser.add_argument("--exp_name", type=str, required=True)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt_path", type=str, default=None)
    src.add_argument("--hf_variant", type=str, default=None)
    parser.add_argument("--cache_path", type=str, default=None,
                        help="local .pth/.npz of --hf_variant")
    parser.add_argument("--num_downs", type=int, default=4)
    parser.add_argument("--ngf", type=int, default=16)
    parser.add_argument("--output_nc", type=int, default=16)
    parser.add_argument("--norm", type=str, default="batch")
    parser.add_argument("--interp", type=str, default="nearest")
    parser.add_argument("--pooling", type=str, default="Max")
    parser.add_argument("--result_path", type=str, default="./")
    parser.add_argument("--lambda_weight", type=float, default=0.75)
    parser.add_argument("--grid_sp", type=int, default=2)
    parser.add_argument("--disp_hw", type=int, default=1)
    parser.add_argument("--selected_niter", type=int, default=80)
    parser.add_argument("--selected_smooth", type=int, default=0)
    parser.add_argument("--grid_sp_adam", type=int, default=2)
    parser.add_argument(
        "--no-ic", action="store_false", dest="ic",
        help="Disable inverse consistency.",
    )
    parser.add_argument("--use_mask", action="store_true")
    parser.add_argument("--path_mask_fixed", type=str, default=None)
    parser.add_argument("--path_mask_moving", type=str, default=None)
    parser.add_argument("--fixed_minclip", type=float, default=None)
    parser.add_argument("--fixed_maxclip", type=float, default=None)
    parser.add_argument("--moving_minclip", type=float, default=None)
    parser.add_argument("--moving_maxclip", type=float, default=None)
    parser.add_argument("--warp_seg", action="store_true")
    parser.add_argument("--path_seg_fixed", type=str, default=None)
    parser.add_argument("--path_seg_moving", type=str, default=None)
    parser.add_argument(
        "--extract_strategy", type=str, default="sliding",
        choices=["sliding", "full", "auto"],
    )
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    convex_adam(
        expname=args.exp_name,
        lambda_weight=args.lambda_weight,
        grid_sp=args.grid_sp,
        disp_hw=args.disp_hw,
        selected_niter=args.selected_niter,
        selected_smooth=args.selected_smooth,
        ckpt_path=args.ckpt_path,
        hf_variant=args.hf_variant,
        grid_sp_adam=args.grid_sp_adam,
        ic=args.ic,
        result_path=args.result_path,
        fixed_image=args.fixed,
        moving_image=args.moving,
        use_mask=args.use_mask,
        fixed_mask=args.path_mask_fixed,
        moving_mask=args.path_mask_moving,
        fixed_minclip=args.fixed_minclip,
        fixed_maxclip=args.fixed_maxclip,
        moving_minclip=args.moving_minclip,
        moving_maxclip=args.moving_maxclip,
        warp_seg=args.warp_seg,
        fixed_seg=args.path_seg_fixed,
        moving_seg=args.path_seg_moving,
        num_downs=args.num_downs,
        ngf=args.ngf,
        output_nc=args.output_nc,
        norm=args.norm,
        interp=args.interp,
        pooling=args.pooling,
        extract_strategy=args.extract_strategy,
        cache_path=args.cache_path,
        device=args.device,
    )


if __name__ == "__main__":
    main()
