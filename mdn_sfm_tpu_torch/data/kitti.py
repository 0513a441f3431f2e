"""KITTI raw-data reader on the host — the port's own copy of
``mdn_sfm_tpu.data.kitti``.

The host only decodes the frame triplet, resizes it to the training size and
reads the per-drive intrinsics; augmentation runs on the card
(:mod:`mdn_sfm_tpu_torch.data.augment`). Decoding takes the native route
(:mod:`mdn_sfm_tpu_torch.native` imgio: libpng/libjpeg decode + bilinear
resize, one call a triplet) when it builds, else PIL + cv2, in that order.
PNG/JPEG decode is bit-exact against PIL; the native resize is within ±1
LSB of ``cv2.resize`` (cv2 rounds in 11-bit fixed point).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .splits import SplitLine

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


def _imread_rgb(path: str) -> np.ndarray:
    """Decode an image to RGB uint8 with PIL."""
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            return np.asarray(img.convert("RGB"))


def _resize_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a uint8 image: cv2, else PIL."""
    try:
        import cv2

        return cv2.resize(img, (width, height))
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))


def _pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


@functools.lru_cache(maxsize=512)
def parse_calib_intrinsics(calib_path: str, cam_id: int) -> np.ndarray:
    """P_rect_0{cam} of a calib_cam_to_cam.txt → (3, 4) float32."""
    with open(calib_path) as f:
        for line in f.readlines():
            parts = line.split()
            if parts and parts[0] == f"P_rect_0{cam_id}:":
                return np.array(parts[1:], dtype=np.float32).reshape(3, 4)
    raise ValueError(f"P_rect_0{cam_id} not found in {calib_path}")


class KittiRawDataset:
    """Map-style reader over the KITTI raw split.

    ``__getitem__`` returns (colors_u8 (F, H, W, 3), K (4, 4)), K rescaled to
    (width, height); frames in ``frame_ids`` order. ``use_native`` None takes
    the native decoder when it builds, else PIL + cv2; when neither exists,
    it raises.
    """

    def __init__(
        self,
        data_path: str,
        lines: list[SplitLine],
        height: int,
        width: int,
        frame_ids: tuple[int, ...] = (0, -1, 1),
        img_ext: str = ".png",
        use_native: bool | None = None,
    ):
        self.data_path = data_path
        self.lines = lines
        self.height = height
        self.width = width
        self.frame_ids = frame_ids
        self.img_ext = img_ext
        if use_native is None:
            from .. import native

            use_native = native.imgio_available()
        if not use_native and not _pil_available():
            raise RuntimeError(
                "no image decoder: the native imgio library did not build (libjpeg/libpng "
                "missing) and PIL is not installed"
            )
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.lines)

    def cache_key(self) -> str:
        """Identity of this reader's decoded output, for
        :class:`mdn_sfm_tpu_torch.data.cache.DecodedCache`."""
        lines = ";".join(f"{l.folder} {l.frame_index} {l.side}" for l in self.lines)
        return f"kitti:{self.data_path}:{self.height}x{self.width}:{self.frame_ids}:{self.img_ext}:{lines}"

    def image_path(self, folder: str, frame_index: int, side: str) -> str:
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder, f"image_0{SIDE_MAP[side]}/data", f_str)

    def intrinsics(self, folder: str, side: str, orig_w: int, orig_h: int) -> np.ndarray:
        calib = os.path.join(self.data_path, folder.split("/")[0], "calib_cam_to_cam.txt")
        K3 = parse_calib_intrinsics(calib, SIDE_MAP[side])[:, :3].copy()
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = K3
        K[0, :] *= self.width / orig_w
        K[1, :] *= self.height / orig_h
        return K

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        line = self.lines[index]
        paths = [self.image_path(line.folder, line.frame_index + i, line.side) for i in self.frame_ids]
        if self.use_native:
            from .. import native

            # one decode + resize call for the triplet; the loader's threads
            # give item-level parallelism
            frames, dims = native.decode_resize_batch(paths, self.height, self.width, n_threads=1)
            i0 = self.frame_ids.index(0)
            return frames, self.intrinsics(line.folder, line.side, int(dims[i0, 0]), int(dims[i0, 1]))

        frames = []
        K = None
        for pos, i in enumerate(self.frame_ids):
            img = _imread_rgb(paths[pos])
            if i == 0:
                h0, w0 = img.shape[:2]
                K = self.intrinsics(line.folder, line.side, w0, h0)
            frames.append(_resize_u8(img, self.height, self.width))
        return np.stack(frames, axis=0), K
