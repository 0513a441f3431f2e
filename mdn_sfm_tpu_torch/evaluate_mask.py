"""Mobile-mask visualization over KITTI-2015 pairs — the port of the root
``evaluate_mask.py``: frozen flow/pose and the mobile decoder, one forward a
batch of ``eval_batch_size``, and with ``--save_pred_masks`` a stacked PNG a
sample (image / probability / binary mask).

    python -m mdn_sfm_tpu_torch.evaluate_mask --raw_dataset_dir kitti --version v1 --idx 0 \\
        --save_pred_masks
    python -m mdn_sfm_tpu_torch.evaluate_mask ... --device cpu
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from . import checkpoints as ckpt
from . import training as T
from .config import Config, parse_eval_cli
from .data.eval_datasets import ValidationMobileMask, prepare_pair
from .data.kitti import _resize_u8
from .metrics import binary_image
from .utils import eval_chunks, resolve_device
from .viz import imwrite


def evaluate(cfg: Config, device: str | torch.device | None = None) -> None:
    """Write the panels under ``{weights folder}/predictions/mobile/{eval_name}``
    on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)
    models = T.load_eval_models(cfg, dev)
    out_dir = os.path.join(ckpt.weights_folder(cfg.log_dir, cfg.version, cfg.idx), "predictions", "mobile",
                           cfg.eval_name)
    os.makedirs(out_dir, exist_ok=True)

    framework = ValidationMobileMask(cfg.raw_dataset_dir, n=cfg.eval_num_samples)
    print(f"-> Computing predictions with size {cfg.width}x{cfg.height}")
    print("-> Evaluating:  Mono evaluation - using median scaling")

    for idxs, n_valid in eval_chunks(len(framework), cfg.eval_batch_size):
        samples = [framework[j] for j in idxs[:n_valid]]
        samples += [samples[-1]] * (len(idxs) - n_valid)
        pairs = [prepare_pair(tgt, nxt, cfg.height, cfg.width) for tgt, nxt in samples]
        tgt = torch.from_numpy(np.concatenate([t for t, _ in pairs])).to(dev)
        ref = torch.from_numpy(np.concatenate([r for _, r in pairs])).to(dev)
        _, mobiles, _, _, _ = T.eval_forward(cfg, models, tgt, ref)
        masks = mobiles[0][..., 0].float().cpu().numpy()

        for bi in range(n_valid):
            if cfg.save_pred_masks:
                imwrite(os.path.join(out_dir, f"{idxs[bi]}.png"), panel(cfg, samples[bi][0], masks[bi]))

    print("\n-> Done!")


def panel(cfg: Config, tgt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[image; probability; binary mask at 0.5] stacked vertically, uint8."""
    tgt_small = _resize_u8(np.clip(tgt, 0, 255).astype(np.uint8), cfg.height, cfg.width)
    m3 = np.repeat(mask[..., None], 3, axis=-1)
    return np.vstack([tgt_small, 255 * m3, 255 * np.repeat(binary_image(mask)[..., None], 3, -1)]).astype(np.uint8)


def main(argv: Sequence[str] | None = None) -> None:
    cfg, device = parse_eval_cli("MDN-SfM PyTorch evaluate_mask", argv)
    evaluate(cfg, device=device)


if __name__ == "__main__":
    main()
