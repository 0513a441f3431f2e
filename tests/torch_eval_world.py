"""The eval CLIs' fixture world for the port's tests: the KITTI layouts of
``tests/fixtures.py`` at the JAX suite's sizes (48×96 frames, a 32×96 net,
as ``tests/test_eval_cli.py``), and one set of weights that both packages'
CLIs load: seeded Flax variables written in the reference ``.pth`` layout
with the JAX package's ``export_pth`` (flow and pose under ``v0``, the
mobile decoder under ``v1``)."""

from __future__ import annotations

import dataclasses
import os

import jax

from fixtures import make_gt_masks, make_kitti2015, make_odometry
from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu_torch.config import Config

H, W = 32, 96  # the net (tiny but /32-divisible)
FRAME_H, FRAME_W = 48, 96
N = 2


@dataclasses.dataclass
class World:
    kw: dict        # the fields both packages' Configs take
    variables: dict  # the Flax variables the .pth files hold

    def jax_cfg(self, **kw) -> JConfig:
        return JConfig(**{**self.kw, **kw}).validate()

    def cfg(self, **kw) -> Config:
        return Config(**{**self.kw, **kw}).validate()


def make_world(tmp_path_factory, eval_out_name: str) -> World:
    root = str(tmp_path_factory.mktemp("kitti"))
    log_dir = str(tmp_path_factory.mktemp("log"))
    out_dir = str(tmp_path_factory.mktemp(eval_out_name))
    gt_dir = os.path.join(out_dir, "gt_masks")
    make_kitti2015(root, n=N, h=FRAME_H, w=FRAME_W)
    make_gt_masks(gt_dir, n=N, h=FRAME_H, w=FRAME_W)
    make_odometry(root, "09", n_frames=5)
    make_odometry(root, "10", n_frames=4)
    kw = dict(
        height=H, width=W, data_root=root, raw_dataset_dir=root, log_dir=log_dir, eval_out_dir=out_dir,
        gt_mask_path=gt_dir, load_weights_folder=os.path.join(log_dir, "v0", "models", "weights_0"),
        version="v1", idx=0, eval_num_samples=N, sequence_length=3, compute_dtype="float32",
        pred_errors=True, save_pred_masks=True, save_pred_motions=True, save_pred_poses=True,
    )
    jcfg = JConfig(**kw).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(jax.jit(lambda k: JT.init_variables(jcfg, models, k))(jax.random.PRNGKey(0)))
    for version, nets in (("v0", ("flownet", "posenet")), ("v1", ("mobile_decoder",))):
        folder = JC.weights_folder(log_dir, version, 0)
        os.makedirs(folder, exist_ok=True)
        for n in nets:
            JC.export_pth(os.path.join(folder, f"{n}.pth"), n, variables[n])
    return World(kw, variables)


def with_out_dir(world: World, out_dir: str) -> World:
    """The same world writing its outputs under ``out_dir``."""
    return World({**world.kw, "eval_out_dir": out_dir}, world.variables)
