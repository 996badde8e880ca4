"""CO3Dv2 reader (no co3d or pytorch3d packages).

Counterpart of ``sparsefusion_tpu/data/co3d.py``, which re-implements the
reference's ``CO3Dv2Wrapper`` on the raw CO3D release:

* ``{root}/{category}/frame_annotations.jgz`` and
  ``sequence_annotations.jgz`` are gzipped JSON, read with the stdlib;
* ``set_lists/set_lists_{subset}.json`` gives subset membership;
* foreground-mask bbox crop with 0.3 context (the threshold decays until
  the box is non-trivial), aspect-preserving resize with top-left
  placement and a valid-region ``mask_crop``, through the port's
  ``ops/image.py``;
* camera intrinsics: dataset NDC -> pixels -> crop-adjusted -> PyTorch3D
  NDC;
* whole sequences sorted by frame timestamp, linspace-subsampled at test
  time and randomly batched at train time;
* empty-mask frames removed, sequences of 10 frames or fewer dropped, the
  two known-bad training sequences excluded.

Images are read with PIL, imported where a frame is loaded.  Scenes come
back as :class:`SceneData` (NHWC numpy).
"""
from __future__ import annotations

import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.ops.image import resize_bilinear, resize_nearest

CO3D_ALL_CATEGORIES = list(reversed([
    "baseballbat", "banana", "bicycle", "microwave", "tv", "cellphone",
    "toilet", "hairdryer", "couch", "kite", "pizza", "umbrella", "wineglass",
    "laptop", "hotdog", "stopsign", "frisbee", "baseballglove", "cup",
    "parkingmeter", "backpack", "toyplane", "toybus", "handbag", "chair",
    "keyboard", "car", "motorcycle", "carrot", "bottle", "sandwich", "remote",
    "bowl", "skateboard", "toaster", "mouse", "toytrain", "book", "toytruck",
    "orange", "broccoli", "plant", "teddybear", "suitcase", "bench", "ball",
    "cake", "vase", "hydrant", "apple", "donut",
]))

CO3D_ALL_TEN = ["donut", "apple", "hydrant", "vase", "cake", "ball", "bench",
                "suitcase", "teddybear", "plant"]

EXCLUDED_SEQUENCES = ("411_55952_107659", "376_42884_85882")


def load_jgz(path: str):
    with gzip.open(path, "rt", encoding="utf8") as f:
        return json.load(f)


# bbox helpers (pytorch3d implicitron semantics)

def get_bbox_from_mask(mask: np.ndarray, thr: float,
                       decrease_quant: float = 0.05):
    """xywh bbox of mask>thr, decaying thr until non-trivial."""
    masks_for_box = np.zeros_like(mask)
    while masks_for_box.sum() <= 1.0:
        masks_for_box = (mask > thr).astype(np.float32)
        thr -= decrease_quant
        if thr < -1:
            break

    def bounds(arr):
        nz = np.flatnonzero(arr)
        if len(nz) == 0:
            return 0, 1
        return int(nz[0]), int(nz[-1]) + 1

    x0, x1 = bounds(masks_for_box.sum(axis=-2))
    y0, y1 = bounds(masks_for_box.sum(axis=-1))
    return np.array([x0, y0, x1 - x0, y1 - y0], np.float32)


def get_clamp_bbox_xyxy(bbox_xywh: np.ndarray, box_crop_context: float):
    """Expand xywh by context then convert to xyxy (min size 2)."""
    bbox = bbox_xywh.astype(np.float32).copy()
    if box_crop_context > 0:
        c = box_crop_context
        bbox[0] -= bbox[2] * c / 2
        bbox[1] -= bbox[3] * c / 2
        bbox[2] += bbox[2] * c
        bbox[3] += bbox[3] * c
    wh = np.maximum(bbox[2:], 2.0)
    return np.array([bbox[0], bbox[1], bbox[0] + wh[0], bbox[1] + wh[1]],
                    np.float32)


def clamp_bbox_to_image(bbox_xyxy: np.ndarray, image_hw):
    h, w = image_hw
    out = bbox_xyxy.copy()
    out[0::2] = np.clip(out[0::2], 0, w)
    out[1::2] = np.clip(out[1::2], 0, h)
    return np.round(out).astype(np.int64)


def crop_around_box(img: np.ndarray, bbox_xyxy: np.ndarray):
    """img (..., H, W); bbox in (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = [int(v) for v in bbox_xyxy]
    return img[..., y0:y1, x0:x1]


# image io and resize

def _load_image_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))  # CHW


def _load_mask(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("L"), np.float32) / 255.0
    return arr[None]  # (1, H, W)


def resize_topleft(image_chw: np.ndarray, out_hw, mode: str):
    """Aspect-preserving resize and zero padding at the bottom and right
    (the reference's ``utils/co3d_dataloader.py:891-918``).

    Returns (resized (C, H, W), minscale, mask_crop (1, H, W)).
    """
    oh, ow = out_hw
    c, h, w = image_chw.shape
    minscale = min(oh / h, ow / w)
    nh = int(np.floor(h * minscale))
    nw = int(np.floor(w * minscale))
    nhwc = torch.from_numpy(np.ascontiguousarray(
        np.transpose(image_chw, (1, 2, 0))[None], dtype=np.float32))
    if mode == "bilinear":
        resized = resize_bilinear(nhwc, (nh, nw), align_corners=False)
    else:
        resized = resize_nearest(nhwc, (nh, nw))
    resized = np.transpose(resized[0].numpy(), (2, 0, 1))
    out = np.zeros((c, oh, ow), np.float32)
    out[:, :nh, :nw] = resized
    mask = np.zeros((1, oh, ow), np.float32)
    mask[:, :nh, :nw] = 1.0
    return out, minscale, mask


# camera conversion

def co3d_camera_to_ndc(viewpoint: Dict, image_size_hw, crop_xyxy,
                       scale: float, out_hw):
    """Dataset NDC intrinsics -> crop/resize-adjusted PyTorch3D NDC
    (``utils/co3d_dataloader.py:647-701``)."""
    principal_point = np.asarray(viewpoint["principal_point"], np.float32)
    focal_length = np.asarray(viewpoint["focal_length"], np.float32)
    half_wh_orig = np.array([image_size_hw[1], image_size_hw[0]],
                            np.float32) / 2.0

    fmt = viewpoint.get("intrinsics_format", "ndc_norm_image_bounds")
    if fmt.lower() == "ndc_norm_image_bounds":
        rescale = half_wh_orig
    elif fmt.lower() == "ndc_isotropic":
        rescale = half_wh_orig.min()
    else:
        raise ValueError(f"Unknown intrinsics format: {fmt}")

    pp_px = half_wh_orig - principal_point * rescale
    f_px = focal_length * rescale
    if crop_xyxy is not None:
        pp_px = pp_px - crop_xyxy[:2]

    half_out = np.array([out_hw[1], out_hw[0]], np.float32) / 2.0
    half_min_out = half_out.min()
    principal_point_ndc = (half_out - pp_px * scale) / half_min_out
    focal_ndc = f_px * scale / half_min_out

    R = np.asarray(viewpoint["R"], np.float32)
    T = np.asarray(viewpoint["T"], np.float32)
    return R, T, focal_ndc, principal_point_ndc


# the dataset

class CO3Dv2Dataset:
    def __init__(self, root: str, category: str,
                 subset: str = "fewview_train", stage: str = "train",
                 sample_batch_size: int = 20, image_size: int = 256,
                 masked: bool = True, box_crop_context: float = 0.3,
                 box_crop_mask_thr: float = 0.4,
                 rng: Optional[np.random.RandomState] = None):
        self.root = root
        self.category = category
        self.subset = subset
        self.stage = stage
        self.sample_batch_size = sample_batch_size
        self.image_size = image_size
        self.masked = masked
        self.box_crop_context = box_crop_context
        self.box_crop_mask_thr = box_crop_mask_thr
        self.rng = rng or np.random.RandomState(0)

        if category == "all":
            cats = CO3D_ALL_CATEGORIES
        elif category == "all_ten":
            cats = CO3D_ALL_TEN
        else:
            cats = [category]

        frames: List[Dict] = []
        for cat in cats:
            frames.extend(load_jgz(
                os.path.join(root, cat, "frame_annotations.jgz")))
        # subset membership by image path
        frame_subset: Dict[str, set] = {}
        for cat in cats:
            path = os.path.join(root, cat, "set_lists",
                                f"set_lists_{subset}.json")
            with open(path) as f:
                set_lists = json.load(f)
            for set_name, entries in set_lists.items():
                for _, _, img_path in entries:
                    frame_subset.setdefault(img_path, set()).add(set_name)

        # filter: empty masks, subset/stage membership
        def keep(fr):
            mask = fr.get("mask")
            if mask is None or (mask.get("mass") or 0) <= 1:
                return False
            subsets = frame_subset.get(fr["image"]["path"])
            return subsets is not None and stage in subsets

        frames = [fr for fr in frames if keep(fr)]
        # group by sequence, ordered by timestamp
        frames.sort(key=lambda fr: (fr["sequence_name"],
                                    fr.get("frame_timestamp") or 0))
        seq_to_frames = defaultdict(list)
        for fr in frames:
            seq_to_frames[fr["sequence_name"]].append(fr)

        if not (stage == "test" and subset == "fewview_test"):
            seq_to_frames = {k: v for k, v in seq_to_frames.items()
                             if len(v) > 10}
        for bad in EXCLUDED_SEQUENCES:
            seq_to_frames.pop(bad, None)

        self.seq_to_frames = seq_to_frames
        self.seq_list = list(seq_to_frames.keys())

    def __len__(self):
        return len(self.seq_list)

    def _pick_batch(self, n_frames: int):
        if self.subset == "fewview_test" and self.stage == "test":
            return list(range(n_frames))
        if self.stage == "test":
            return np.linspace(0, n_frames - 1,
                               self.sample_batch_size).astype(int).tolist()
        perm = self.rng.permutation(n_frames)
        return perm[:min(n_frames, self.sample_batch_size)].tolist()

    def load_frame(self, fr: Dict):
        """One frame -> (image, mask, valid_region, bbox_ndc, R, T, f, c)."""
        out_hw = (self.image_size, self.image_size)
        mask = _load_mask(os.path.join(self.root, fr["mask"]["path"]))
        image_hw = mask.shape[-2:]
        bbox_xywh = get_bbox_from_mask(mask[0], self.box_crop_mask_thr)
        crop_xyxy = clamp_bbox_to_image(
            get_clamp_bbox_xyxy(bbox_xywh, self.box_crop_context), image_hw)
        mask_c = crop_around_box(mask, crop_xyxy)
        fg, _, _ = resize_topleft(mask_c, out_hw, "nearest")

        img = _load_image_rgb(os.path.join(self.root, fr["image"]["path"]))
        img_c = crop_around_box(img, crop_xyxy)
        img_r, scale, mask_crop = resize_topleft(img_c, out_hw, "bilinear")

        # valid bbox in NDC from the mask_crop support (the reference's
        # co3d_dataloader.py:470-486)
        ys, xs = np.nonzero(mask_crop[0])
        half = self.image_size // 2
        valid_bbox = np.array([ys.min(), xs.min(), ys.max(), xs.max()],
                              np.float32)
        valid_bbox = np.clip((valid_bbox - half) / half, -1.0, 1.0)

        R, T, f, c = co3d_camera_to_ndc(
            fr["viewpoint"], image_hw, crop_xyxy.astype(np.float32), scale,
            out_hw)
        return img_r, fg, mask_crop, valid_bbox, R, T, f, c

    def __getitem__(self, index: int) -> SceneData:
        seq = self.seq_list[index]
        frames = self.seq_to_frames[seq]
        batch = self._pick_batch(len(frames))
        # order by timestamp (frames pre-sorted; batch may be shuffled)
        batch = sorted(batch,
                       key=lambda i: frames[i].get("frame_timestamp") or 0)

        imgs, masks, valids, bboxes = [], [], [], []
        Rs, Ts, fs, cs = [], [], [], []
        for i in batch:
            img, fg, mask_crop, vbox, R, T, f, c = self.load_frame(frames[i])
            if self.masked:
                img = img * fg
            imgs.append(np.transpose(img, (1, 2, 0)))
            masks.append(np.transpose(fg, (1, 2, 0)))
            valids.append(np.transpose(mask_crop, (1, 2, 0)))
            bboxes.append(vbox)
            Rs.append(R)
            Ts.append(T)
            fs.append(f)
            cs.append(c)

        n = len(imgs)
        return SceneData(
            images=np.stack(imgs).astype(np.float32),
            R=np.stack(Rs), T=np.stack(Ts), f=np.stack(fs), c=np.stack(cs),
            valid_region=np.stack(valids).astype(np.float32),
            image_size=np.full((n, 2), float(self.image_size), np.float32),
            masks=np.stack(masks).astype(np.float32),
            bbox=np.stack(bboxes),
            sequence_name=seq,
        )
