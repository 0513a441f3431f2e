"""Cityscapes/KITTI instance-label table — the port's own copy of
``mdn_sfm_tpu.labels``: the id → trainId mapping with the reference's 11
thing classes at trainIds 1..11 (everything else decodes to 0 or 255 and is
skipped), and each label's colour for the eval panels' boxes."""

from __future__ import annotations

from typing import NamedTuple


class Label(NamedTuple):
    name: str
    id: int
    trainId: int
    color: tuple[int, int, int]


LABELS = [
    Label("unlabeled", 0, 0, (0, 0, 0)),
    Label("ego vehicle", 1, 0, (0, 0, 0)),
    Label("rectification border", 2, 0, (0, 0, 0)),
    Label("out of roi", 3, 0, (0, 0, 0)),
    Label("static", 4, 0, (0, 0, 0)),
    Label("dynamic", 5, 1, (111, 74, 0)),
    Label("ground", 6, 0, (81, 0, 81)),
    Label("road", 7, 0, (128, 64, 128)),
    Label("sidewalk", 8, 0, (244, 35, 232)),
    Label("parking", 9, 0, (250, 170, 160)),
    Label("rail track", 10, 0, (230, 150, 140)),
    Label("building", 11, 0, (70, 70, 70)),
    Label("wall", 12, 0, (102, 102, 156)),
    Label("fence", 13, 0, (190, 153, 153)),
    Label("guard rail", 14, 0, (180, 165, 180)),
    Label("bridge", 15, 0, (150, 100, 100)),
    Label("tunnel", 16, 0, (150, 120, 90)),
    Label("pole", 17, 0, (153, 153, 153)),
    Label("polegroup", 18, 0, (153, 153, 153)),
    Label("traffic light", 19, 0, (250, 170, 30)),
    Label("traffic sign", 20, 0, (220, 220, 0)),
    Label("vegetation", 21, 0, (107, 142, 35)),
    Label("terrain", 22, 0, (152, 251, 152)),
    Label("sky", 23, 0, (70, 130, 180)),
    Label("person", 24, 2, (220, 20, 60)),
    Label("rider", 25, 3, (255, 0, 0)),
    Label("car", 26, 4, (0, 0, 142)),
    Label("truck", 27, 5, (0, 0, 70)),
    Label("bus", 28, 6, (0, 60, 100)),
    Label("caravan", 29, 7, (0, 0, 90)),
    Label("trailer", 30, 8, (0, 0, 110)),
    Label("train", 31, 9, (0, 80, 100)),
    Label("motorcycle", 32, 10, (0, 0, 230)),
    Label("bicycle", 33, 11, (119, 11, 32)),
    Label("license plate", -1, 255, (0, 0, 142)),
]

ID2LABEL = {l.id: l for l in LABELS}
TRAINID2LABEL = {l.trainId: l for l in LABELS if l.trainId not in (0, 255)}


def kitti_decode(instance_id: int) -> int:
    """KITTI instance PNG value → trainId; instance maps store
    ``semantic_id * 256 + instance``."""
    label = ID2LABEL.get(int(instance_id) // 256)
    return label.trainId if label is not None else 255
