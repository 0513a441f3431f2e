"""The training loop — the port of ``mdn_sfm_tpu.trainer``.

Owns IO and orchestration; the math is :mod:`mdn_sfm_tpu_torch.training`.
The epoch loop, TensorBoard logging (when ``torch.utils.tensorboard``
imports), checkpoints in the reference layout with exact ``--resume auto``,
the SIGTERM/SIGINT checkpoint at the next batch boundary, inline validation
on KITTI-2015 (when ``data_root/data_scene_flow`` exists), the epipolar
percentile tool and the hyperparameter grid.

One process on one device (``cuda`` unless asked otherwise). An epoch's
order depends only on (seed, epoch) and a step's augmentation only on
(seed, step), so a run that is interrupted and resumed takes the batches
and draws of one that was not.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time

import numpy as np
import torch

from . import checkpoints as ckpt
from . import training as T
from .config import Config, Mode
from .data import HostLoader, KittiRawDataset, SyntheticDataset, read_split_lines, split_path
from .data.augment import augment_batch
from .data.splits import repo_root, sample_key, shard_for_host
from .geometry import gauss_distance_weight
from .losses import epipolar_loss_terms
from .masks import build_mask_provider
from .ops.epipolar import EpipolarMap, epipolar_abs_residual_maps
from .utils import resolve_device
from .viz import flow_to_image, normalize_image, sec_to_hm_str

# the step at which --profile_dir starts and stops torch.profiler
PROFILE_STEPS = (10, 15)


class Trainer:
    """End-to-end training pipeline on one device."""

    def __init__(self, cfg: Config, synthetic: bool = False, debug_nans: bool = False,
                 device: str | torch.device | None = None):
        self.cfg = cfg.validate()
        self.synthetic = synthetic
        self.device = resolve_device(device)
        self.save_path = os.path.join(cfg.log_dir, cfg.v_save)
        if debug_nans:
            # autograd's anomaly mode, as the reference runs it: every backward
            # op checks its output for NaN (slow; opt-in)
            torch.autograd.set_detect_anomaly(True)
        if cfg.profile_dir:
            os.makedirs(cfg.profile_dir, exist_ok=True)
        self._profiler = None

        self.writers = self._make_writers()
        self._stop_requested = False
        self._pending_save: threading.Thread | None = None
        self._pending_save_error: BaseException | None = None
        self.save_seconds: list[dict] = []   # per save: host copy and file write
        self.step_log: list[tuple[int, float, float]] = []  # logged steps: (step, seconds, loss)
        self.sample_history: list[tuple[int, list[int]]] = []  # (step, dataset indices)
        self._initialize_dataset()
        self._initialize_models()

        print(f"{self.device.type}: training model {cfg.v_save} (mode={cfg.mode.value})")
        print(f"Models and tensorboard files save to: {cfg.log_dir}/{cfg.v_save}\n")
        self.save_opts()

    # ------------------------------------------------------------ setup

    def _make_writers(self):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return {
                "train": SummaryWriter(os.path.join(self.save_path, "tb_train")),
                "val": SummaryWriter(os.path.join(self.save_path, "tb_val")),
            }
        except ImportError:  # tensorboard is optional
            return None

    def _initialize_dataset(self):
        cfg = self.cfg
        if self.synthetic:
            n = cfg.limit_train_samples or max(cfg.batch_size * 8, 64)
            dataset = SyntheticDataset(n, cfg.height, cfg.width, len(cfg.frame_ids))
            self.sample_keys = [str(i) for i in range(n)]
        else:
            lines = read_split_lines(split_path(repo_root(), cfg.split, "train"))
            if cfg.limit_train_samples:
                lines = lines[: cfg.limit_train_samples]
            lines = shard_for_host(lines)
            img_ext = ".png" if cfg.png else ".jpg"
            dataset = KittiRawDataset(cfg.data_path, lines, cfg.height, cfg.width, cfg.frame_ids, img_ext)
            if cfg.cache_decoded:
                from .data.cache import DecodedCache

                # sound because augmentation runs on the card: an item's host
                # output depends only on (bytes, H, W)
                dataset = DecodedCache(dataset, cfg.cache_decoded)
            self.sample_keys = [sample_key(l) for l in lines]

        self.train_loader = HostLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                       num_workers=cfg.num_workers, drop_last=True)
        self.steps_per_epoch = len(self.train_loader)
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs
        self.mask_provider = build_mask_provider(cfg, self.device)
        # the precomputed provider serves zeros for a missing file, so a
        # mask_dir or key-scheme mismatch would train DS/DC against all-zero
        # masks: check every key, fail at 0 hits, report the coverage
        if cfg.mask_provider == "precomputed" and self.sample_keys:
            hits = sum(os.path.exists(os.path.join(cfg.mask_dir, f"{k}.png")) for k in self.sample_keys)
            n = len(self.sample_keys)
            if hits == 0:
                raise FileNotFoundError(
                    f"mask_provider=precomputed found 0/{n} sample keys in {cfg.mask_dir!r} (e.g. "
                    f"{self.sample_keys[0]}.png) — every mask would load as zeros. Generate masks with "
                    "python -m mdn_sfm_tpu_torch.precompute_masks (the key scheme is "
                    "data/splits.py::sample_key).")
            print(f"precomputed masks: {hits}/{n} sample keys covered ({hits / n:.1%}); "
                  "missing keys train with all-zero masks")

        # inline validation on KITTI-2015 scene-flow pairs, when on disk
        self.val_dataset = None
        self._val_idx = 0
        if not self.synthetic and os.path.isdir(os.path.join(cfg.data_root, "data_scene_flow")):
            from .data.eval_datasets import KittiSegDataset

            self.val_dataset = KittiSegDataset(cfg.data_root, cfg.height, cfg.width)
        n_val = len(self.val_dataset) if self.val_dataset else 0
        print(f"\n{len(dataset):d} training items and {n_val:d} validation items\n")

    def _load_nets(self, folder: str, names: tuple[str, ...]) -> int:
        """Load ``names`` from ``folder`` into the models (key intersection);
        returns the checkpoint's step."""
        return ckpt.load_into(folder, T.modules_by_name(self.models), names)

    def _initialize_models(self):
        cfg = self.cfg
        self.models = T.build_models(cfg, device=self.device)

        # flow/pose: always from v0/weights_0, as the reference does (the
        # starting point when fine_tune_flow_motion trains them too)
        folder = ckpt.weights_folder(cfg.log_dir, "v0", 0)
        to_load = tuple(n for n in cfg.models_to_load if n != "mobile_decoder")
        if os.path.isdir(folder) and to_load:
            self._load_nets(folder, to_load)
            print(f"Loaded {to_load} from {folder}")
        else:
            print("WARNING: no pretrained flow/pose checkpoint found — training "
                  f"against randomly initialized supervision ({folder})")

        self.start_step = 0
        self.start_idx_save = 0
        resume_folder = None
        if cfg.resume == "auto":
            # continue v_save from its own latest checkpoint (params + Adam +
            # step); a fresh start when there is none yet
            latest = ckpt.latest_weights_idx(cfg.log_dir, cfg.v_save)
            if latest is not None:
                resume_folder = ckpt.weights_folder(cfg.log_dir, cfg.v_save, latest)
                self.start_step = self._load_nets(resume_folder, T.trainable_nets(cfg))
                self.start_idx_save = latest + 1
                print(f"Auto-resume: {resume_folder} (step {self.start_step})")
        self._resumed_auto = resume_folder is not None
        if (resume_folder is None and (cfg.fine_tune_flow_motion or cfg.load_adam)
                and "mobile_decoder" in cfg.models_to_load):
            mfolder = ckpt.weights_folder(cfg.log_dir, cfg.v_load, cfg.idx_load)
            if os.path.isdir(mfolder):
                self.start_step = self._load_nets(mfolder, ("mobile_decoder",))
                print(f"Loaded mobile_decoder from {mfolder}")
        # The step counter carries over between fine-tune stages, so this
        # run's progress is step - base_step; an auto-resumed run inherits
        # the interrupted run's base from its meta.json
        if resume_folder is not None:
            meta = ckpt.read_meta(resume_folder)
            self.base_step = meta.get("base_step", 0)
            if "base_step" not in meta and self.start_step > 0:
                print(
                    "WARNING: resumed meta.json has no base_step — treating step "
                    f"{self.start_step} entirely as this run's progress. A resumed fine-tune "
                    "stage may mis-position or exit as already complete; restart with a "
                    "fresh --v_save if so."
                )
        else:
            self.base_step = self.start_step

        self.opt = T.make_optimizer(cfg, self.models, self.steps_per_epoch)
        if cfg.load_adam or resume_folder is not None:
            mfolder = resume_folder or ckpt.weights_folder(cfg.log_dir, cfg.v_load, cfg.idx_load)
            _, adam, _ = ckpt.load_checkpoint(mfolder, {}, (), load_adam=True)
            if adam is not None:
                self.opt.load_state_dict(adam)
                print("Loading Adam state...")
            else:
                print("Cannot find Adam weights so Adam is randomly initialized")
        # the step counter: the augmentation generator's seed and the
        # checkpoints' position (the LR follows Adam's own count)
        self.step = self.start_step

        # a live Mask R-CNN provider runs inside the step on the augmented
        # frame (d2_fuse_step); its weights are frozen, rebuilt from their
        # .pth and never checkpointed
        self.fused_provider = (self.mask_provider if cfg.d2_fuse_step and hasattr(self.mask_provider, "union_fn")
                               else None)

        def step_fn(batch: dict, generator: torch.Generator):
            return T.train_step(cfg, self.models, self.opt, batch, generator=generator,
                                provider=self.fused_provider)

        self.step_fn = step_fn

    # ----------------------------------------------------------- running

    def save_opts(self):
        self.cfg.save(os.path.join(self.save_path, "models", "opt.json"))

    def save_model(self, idx_save: int, async_write: bool = False):
        """Write ``weights_{idx_save}``: the nets being trained (the mobile
        decoder; flow and pose too, with their BN statistics, when
        ``fine_tune_flow_motion``), Adam and meta.json.

        The copy to the host is taken here, synchronously: the optimizer
        updates the parameters in place, so the next step must not reach the
        tensors being written. With ``async_write`` (the save_frequency saves)
        the file write runs on a background thread; a later save or
        :meth:`_join_pending_save` waits for it and raises its error. The
        default writes before returning."""
        self._join_pending_save()
        folder = ckpt.weights_folder(self.cfg.log_dir, self.cfg.v_save, idx_save)
        t0 = time.perf_counter()
        mods = T.modules_by_name(self.models)
        nets = {n: ckpt.to_host(mods[n].state_dict()) for n in T.trainable_nets(self.cfg)}
        adam = ckpt.to_host(self.opt.state_dict())
        step, base = self.step, self.base_step
        copy_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            ckpt.save_checkpoint(folder, nets, adam, step, base_step=base)
            self.save_seconds.append({"idx": idx_save, "step": step, "host_copy_s": copy_s,
                                      "write_s": time.perf_counter() - t1, "async": async_write})

        if not async_write:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:  # re-raised by _join_pending_save
                self._pending_save_error = e

        self._pending_save = threading.Thread(target=run, daemon=False)
        self._pending_save.start()

    def _join_pending_save(self):
        """Wait for the last background checkpoint write; a failure in it
        (disk full, a serialization error) raises here."""
        t = self._pending_save
        if t is not None:
            t.join()
            self._pending_save = None
        err = self._pending_save_error
        if err is not None:
            self._pending_save_error = None
            raise RuntimeError("async checkpoint write failed") from err

    def _device_batch(self, arrays: tuple, keys: list[str] | None = None) -> dict:
        """Host arrays → the device, from pinned memory without a sync on
        the card. With ``keys`` (the batch's sample keys) and a mask provider
        that is not fused into the step, the batch carries its instance
        masks: a keyed lookup, or the live provider on the RAW host target
        frame. (Deviation, as in the JAX package: the reference's detectron2
        sees the augmented frame; only the fused path reproduces that.)"""
        colors, K = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        if self.device.type == "cuda":
            colors, K = colors.pin_memory(), K.pin_memory()
        batch = {"colors_u8": colors.to(self.device, non_blocking=True),
                 "K": K.to(self.device, non_blocking=True)}
        if keys is not None and self.mask_provider is not None and self.fused_provider is None:
            cfg = self.cfg
            if hasattr(self.mask_provider, "union_masks_from_images"):
                masks = self.mask_provider.union_masks_from_images(batch["colors_u8"][:, 0], cfg.height, cfg.width)
            else:
                masks = torch.from_numpy(self.mask_provider.union_masks(keys, cfg.height, cfg.width))
            batch["instance_mask"] = masks.to(self.device, non_blocking=True)
        return batch

    def train(self):
        """The epoch loop. SIGTERM/SIGINT during it checkpoint at the next
        batch boundary and return, for ``--resume auto`` to continue."""
        cfg = self.cfg
        self.epoch = 0
        self.idx_save = self.start_idx_save
        self.start_time = time.time()
        self._stop_requested = False

        # exact mid-epoch resume (auto only; a manual --v_load run is a fresh
        # num_epochs run): re-enter the interrupted epoch, skip its batches
        start_epoch, self._skip_batches = 0, 0
        already_complete = False
        if self._resumed_auto and self.steps_per_epoch > 0:
            start_epoch, self._skip_batches = divmod(self.start_step - self.base_step, self.steps_per_epoch)
            if start_epoch >= cfg.num_epochs:
                already_complete = True
                print(f"Auto-resume: run already complete at step {self.start_step}")

        def _request_stop(signum, frame):
            print(f"signal {signum}: checkpointing at the next batch boundary")
            self._stop_requested = True

        prev = {}
        # the loop's wall clock, from the first batch request to the last
        # loss read: the loader's waits and the checkpoints' host copies in it
        self.loop_start = self.last_loss_read = time.perf_counter()
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, _request_stop)
        except ValueError:
            prev = {}  # not the main thread: no handler, the flag still works
        try:
            for self.epoch in range(start_epoch, cfg.num_epochs):
                self.run_epoch()
                if self._stop_requested:
                    break
            if not already_complete:
                # restarting a finished run is a no-op, not a duplicate checkpoint
                self.save_model(self.idx_save)
        finally:
            try:
                self._join_pending_save()  # train() returns with the files on disk
            finally:
                if self._profiler is not None:
                    self._stop_profiler()
                for sig, h in prev.items():
                    signal.signal(sig, h)

    def run_epoch(self):
        # the shuffle follows the trainer's epoch, not the loader's own count
        self.train_loader.epoch = self.epoch
        skip, self._skip_batches = getattr(self, "_skip_batches", 0), 0
        self._run_epoch_single(skip)
        hit = getattr(self.train_loader.dataset, "hit_fraction", None)
        if hit is not None and hit < 1.0:
            print(f"decoded cache: {hit:.1%} of items cached")

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_profiler(self):
        prof, self._profiler = self._profiler, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.cfg.profile_dir, f"trace_step{self.step}.json"))

    def _run_epoch_single(self, skip: int = 0):
        cfg = self.cfg
        for batch_idx, (arrays, idxs) in enumerate(self.train_loader.iter_batches(skip), start=skip):
            if self._stop_requested:
                return
            if cfg.profile_dir and self.step == PROFILE_STEPS[0] and self._profiler is None:
                self._start_profiler()
            if cfg.profile_dir and self.step == PROFILE_STEPS[1] and self._profiler is not None:
                self._stop_profiler()
            before = time.time()
            self.sample_history.append((self.step, [int(i) for i in idxs]))
            batch = self._device_batch(arrays, [self.sample_keys[int(i)] for i in idxs])
            metrics, aux = self.step_fn(batch, T.step_generator(cfg.seed, self.step, self.device))

            early = batch_idx % cfg.log_frequency == 0 and self.step < 2000
            late = self.step % 1000 == 0
            if early or late:
                loss = float(metrics["loss"])  # the only sync, on log steps
                self.last_loss_read = time.perf_counter()
                self.step_log.append((self.step, time.time() - before, loss))
                self.log_time(batch_idx, self.step_log[-1][1], loss)
            if batch_idx % 50 == 0:
                self.log(metrics, aux, log_image=early or late)
                self.val()

            self.step += 1
            if self.step % cfg.save_frequency == 0:
                self.save_model(self.idx_save, async_write=True)
                self.idx_save += 1

    def log_time(self, batch_idx: int, duration: float, loss: float):
        samples_per_sec = self.cfg.batch_size / max(duration, 1e-9)
        sofar = time.time() - self.start_time
        left = (self.num_total_steps / (self.step + 1) - 1.0) * sofar
        print(
            f"epoch {self.epoch} | batch {batch_idx:>6} | loss: {loss:.5f} | "
            f"examples/s: {samples_per_sec:5.1f} | elapsed: {sec_to_hm_str(sofar)} | "
            f"left: {sec_to_hm_str(left)}",
            flush=True,
        )

    def log(self, metrics: dict, aux, log_image: bool = False, num: int = 4):
        """TensorBoard scalars and image panels."""
        # the photometric loss has a degenerate optimum: flow that warps every
        # sample out of bounds makes the masked mean exactly 0 with no
        # gradient. Exact 0.0 never occurs in healthy training: warn once
        if ("photo" in metrics and float(metrics["photo"]) == 0.0 and self.step > 0
                and not getattr(self, "_warned_photo_zero", False)):
            self._warned_photo_zero = True
            print(
                f"WARNING: photometric loss is EXACTLY 0 at step {self.step} — "
                "the flow net has likely diverged to the all-invalid-warp "
                "degenerate optimum (every sample out of bounds; no gradient). "
                "Check flow EPE; lower the learning rate or raise texture contrast.",
                flush=True,
            )
        if self.writers is None:
            return
        w = self.writers["train"]
        for k in ("loss", "epip", "smooth", "consis", "grad_norm"):
            w.add_scalar(k, float(metrics[k]), self.step)
        if "photo" in metrics:
            w.add_scalar("photo", float(metrics["photo"]), self.step)
        if not log_image:
            return

        def host(x):
            return x.float().cpu().numpy()

        frame_ids = self.cfg.ref_frame_ids
        min_mob = host(aux.min_mobiles[0])
        epips = {i: host(aux.epipolars[(i, 0)]) for i in frame_ids}
        oris = {i: host(aux.epipolar_ori[(i, 0)]) for i in frame_ids}
        flows = {i: host(aux.flows[(i, 0)]) for i in frame_ids}
        for j in range(min(num, min_mob.shape[0])):
            epip = np.hstack([normalize_image(epips[i][j, ..., 0]) for i in frame_ids])
            epip_ori = np.hstack([normalize_image(oris[i][j, ..., 0]) for i in frame_ids])
            flow_img = np.vstack([flow_to_image(flows[i][j]) for i in frame_ids])
            w.add_image(f"{j}/epip", epip[None], self.step)
            w.add_image(f"{j}/epip_ori", epip_ori[None], self.step)
            w.add_image(f"{j}/mobile_min", min_mob[j].transpose(2, 0, 1), self.step)
            w.add_image(f"{j}/mobile_min_bi", (min_mob[j] >= 0.4).astype(np.float32).transpose(2, 0, 1),
                        self.step)
            w.add_image(f"{j}/flow", flow_img, self.step, dataformats="HWC")

    def val(self):
        """Validate on one KITTI-2015 pair and log its images."""
        if self.val_dataset is None or self.writers is None:
            return
        from .metrics import binary_image

        cfg = self.cfg
        dev = self.device
        inputs = self.val_dataset[self._val_idx % len(self.val_dataset)]
        self._val_idx += 1

        tgt = torch.from_numpy(inputs[("color", 0)])[None].to(dev)
        ref = torch.from_numpy(inputs[("color", 1)])[None].to(dev)
        flows, mobiles, _, _, cam = T.eval_forward(cfg, self.models, tgt, ref)
        gw = (gauss_distance_weight(cfg.height, cfg.width, 1, cfg.gauss_sigma1, cfg.gauss_sigma2, dev)[0]
              if cfg.mode == Mode.TG else None)
        # the live provider's union mask on the val frame, as the reference
        # runs detectron2 there; a keyed or absent provider has none
        union = None
        if hasattr(self.mask_provider, "union_masks_from_images"):
            tgt_u8 = ((tgt * 0.225 + 0.45) * 255.0).clamp(0, 255).to(torch.uint8)
            union = self.mask_provider.union_masks_from_images(tgt_u8, cfg.height, cfg.width)
        viz_cfg = cfg
        if union is None and cfg.mode in (Mode.DS, Mode.DC):
            # DS/DC post-processing needs an instance mask: log SN-style maps
            viz_cfg = dataclasses.replace(cfg, mode=Mode.SN, w_d2_sim=0.0)
        inv_K = torch.from_numpy(inputs["inv_K"])[None].to(dev)
        (resid,) = epipolar_abs_residual_maps(
            [EpipolarMap(flows[0].float(), (float(cfg.width), float(cfg.height)), inv_K,
                         cam[:, :3, :3], cam[:, :3, 3])])
        epip_loss, epip_map, epip_ori = epipolar_loss_terms(viz_cfg, resid, mobiles[0], union, gw)

        w = self.writers["val"]
        w.add_scalar("epipolar loss", float(epip_loss), self.step)
        mob = mobiles[0][0, ..., 0].float().cpu().numpy()
        w.add_image("0/target", normalize_image(tgt[0].cpu().numpy()).transpose(2, 0, 1), self.step)
        w.add_image("0/epip", normalize_image(epip_map[0, ..., 0].cpu().numpy())[None], self.step)
        w.add_image("0/epip_ori", normalize_image(epip_ori[0, ..., 0].cpu().numpy())[None], self.step)
        w.add_image("0/mobile", mob[None], self.step)
        w.add_image("0/mobile_bi", binary_image(mob, 0.4)[None], self.step)
        anns = inputs.get("annotations")
        if anns and "instance_img" in inputs:
            from .viz import draw_boxes_rgb

            inst = np.clip(np.asarray(inputs["instance_img"]), 0, 255).astype(np.uint8)
            boxes = np.array([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
            w.add_image("0/instances", draw_boxes_rgb(inst, boxes, None), self.step, dataformats="HWC")
        if union is not None:
            w.add_image("0/instance_union", union[0][None].cpu().numpy(), self.step)

    # ------------------------------------------------------------- tools

    def epipolar_statics(self, num_quantile: int = 1000, max_batches: int | None = None) -> np.ndarray:
        """Epipolar percentile statistics over the training set: the
        calibration behind ``--threshold`` (9.22 for eigen_zhou). Per batch,
        the |residual| maps of both reference frames in one call
        (``epipolar_abs_residual_maps``), and their per-image quantiles at
        ``num_quantile`` levels (``torch.quantile``, linear)."""
        cfg = self.cfg
        dev = self.device
        percentage = torch.linspace(0.0, 1.0, num_quantile, device=dev)
        all_q: dict = {i: [] for i in cfg.ref_frame_ids}
        for bi, (arrays, _idxs) in enumerate(self.train_loader):
            if max_batches is not None and bi >= max_batches:
                break
            batch = self._device_batch(arrays)
            with torch.no_grad():
                colors, inv_Ks, _ = augment_batch(cfg, batch["colors_u8"], batch["K"], train=False)
                maps = []
                for i in cfg.ref_frame_ids:
                    flows, _, _, _, cam = T.eval_forward(cfg, self.models, colors[(0, 0)], colors[(i, 0)])
                    maps.append(EpipolarMap(flows[0].float(), (float(cfg.width), float(cfg.height)),
                                            inv_Ks[0], cam[:, :3, :3], cam[:, :3, 3]))
                for i, e in zip(cfg.ref_frame_ids, epipolar_abs_residual_maps(maps)):
                    q = torch.quantile(e.reshape(e.shape[0], -1), percentage, dim=1)  # (num_quantile, B)
                    all_q[i].append(q.cpu().numpy())

        percentiles = np.stack([np.concatenate(all_q[i], axis=1) for i in cfg.ref_frame_ids])
        os.makedirs(cfg.other_files_path, exist_ok=True)
        np.save(os.path.join(cfg.other_files_path, f"{cfg.split}_percentiles.npy"), percentiles)
        thresholds = np.percentile(percentiles.reshape(-1), [80, 85, 88, 90, 92, 95, 98, 99])
        np.savetxt(os.path.join(cfg.other_files_path, f"{cfg.split}_thresholds"), thresholds)
        return thresholds

    def hyperparameter_try(self, name: str, values: list[float], batches_per_value: int = 200) -> dict:
        """Grid search over one config field: per value, a fresh mobile
        decoder and Adam beside the loaded frozen nets, ``batches_per_value``
        steps; returns the last loss of each value."""
        results = {}
        for turn, v in enumerate(values):
            print(f"\nEpoch {turn} | {name}={v}:")
            new_cfg = dataclasses.replace(self.cfg, **{name: v}).validate()
            models = T.build_models(new_cfg, device=self.device)
            models.flow.load_state_dict(self.models.flow.state_dict())
            models.pose.load_state_dict(self.models.pose.state_dict())
            opt = T.make_optimizer(new_cfg, models, self.steps_per_epoch)
            last = None
            for bi, (arrays, idxs) in enumerate(self.train_loader):
                if bi >= batches_per_value:
                    break
                batch = self._device_batch(arrays, [self.sample_keys[int(i)] for i in idxs])
                metrics, _ = T.train_step(new_cfg, models, opt, batch, provider=self.fused_provider,
                                          generator=T.step_generator(new_cfg.seed, bi, self.device))
                if self.writers and bi % 50 == 0:
                    for k in ("loss", "epip", "smooth", "consis"):
                        self.writers["train"].add_scalar(f"{v}/{k}", float(metrics[k]), bi)
                last = float(metrics["loss"])
            results[v] = last
        return results
