"""co3d_toy dataset: the reference's preprocessed per-category pickle.

``{root}/{cat}/{cat}_toy.pt`` holds ``{category: [scene_dict, ...]}``,
each scene dict in the reference's contract; scenes come back as
:class:`SceneData`.
"""
from __future__ import annotations

import os
from typing import List

import torch

from sparsefusion_tpu_torch.data.contract import SceneData


class CO3DToyDataset:
    def __init__(self, root: str, category: str):
        self.root = root
        self.category = category
        path = os.path.join(root, category, f"{category}_toy.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"toy dataset not found at {path}; download per the "
                f"reference README or use the synthetic dataset")
        dataset = torch.load(path, map_location="cpu", weights_only=False)
        self.seq_list: List = dataset[category]

    def __len__(self) -> int:
        return len(self.seq_list)

    def __getitem__(self, index: int) -> SceneData:
        return SceneData.from_reference_dict(
            self.seq_list[index],
            sequence_name=f"{self.category}_{index:03d}")
