"""Cityscapes/KITTI instance-label table — the port's own copy of the part
of ``mdn_sfm_tpu.labels`` that inline validation reads: the id → trainId
mapping with the reference's 11 thing classes at trainIds 1..11 (everything
else decodes to 0 or 255 and is skipped)."""

from __future__ import annotations

from typing import NamedTuple


class Label(NamedTuple):
    name: str
    id: int
    trainId: int


LABELS = [
    Label("unlabeled", 0, 0), Label("ego vehicle", 1, 0), Label("rectification border", 2, 0),
    Label("out of roi", 3, 0), Label("static", 4, 0), Label("dynamic", 5, 1),
    Label("ground", 6, 0), Label("road", 7, 0), Label("sidewalk", 8, 0),
    Label("parking", 9, 0), Label("rail track", 10, 0), Label("building", 11, 0),
    Label("wall", 12, 0), Label("fence", 13, 0), Label("guard rail", 14, 0),
    Label("bridge", 15, 0), Label("tunnel", 16, 0), Label("pole", 17, 0),
    Label("polegroup", 18, 0), Label("traffic light", 19, 0), Label("traffic sign", 20, 0),
    Label("vegetation", 21, 0), Label("terrain", 22, 0), Label("sky", 23, 0),
    Label("person", 24, 2), Label("rider", 25, 3), Label("car", 26, 4),
    Label("truck", 27, 5), Label("bus", 28, 6), Label("caravan", 29, 7),
    Label("trailer", 30, 8), Label("train", 31, 9), Label("motorcycle", 32, 10),
    Label("bicycle", 33, 11), Label("license plate", -1, 255),
]

ID2LABEL = {l.id: l for l in LABELS}


def kitti_decode(instance_id: int) -> int:
    """KITTI instance PNG value → trainId; instance maps store
    ``semantic_id * 256 + instance``."""
    label = ID2LABEL.get(int(instance_id) // 256)
    return label.trainId if label is not None else 255
