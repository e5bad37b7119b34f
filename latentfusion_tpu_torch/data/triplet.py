"""Triplets of items (anchor, positive, negative) by pose distance
(counterpart of ``latentfusion_tpu/data/triplet.py``); ``random`` draws in
the JAX package's order."""
from __future__ import annotations

import logging
import random

import numpy as np

logger = logging.getLogger(__name__)


class TripletDataset:

    def __init__(self, dataset, data_indices, dist_matrix, k=3,
                 easy_neg_prob=0.0):
        self.dataset = dataset
        self.dist_matrix = np.asarray(dist_matrix)
        self.data_indices = list(data_indices)
        self.easy_neg_prob = easy_neg_prob
        self.k = k

    def __len__(self):
        return len(self.data_indices)

    def _sample_positive(self, anchor_idx):
        """k nearest (excluding self) -> random pick."""
        order = np.argsort(self.dist_matrix[anchor_idx])[:self.k]
        pos_select = random.randrange(1, len(order))
        pos_ann_idx = int(order[pos_select])
        return (self.data_indices[pos_ann_idx],
                float(self.dist_matrix[anchor_idx][pos_ann_idx]))

    def _sample_easy_negative(self, anchor_idx, frac=0.25):
        bottom_k = int(frac * len(self.data_indices))
        order = np.argsort(self.dist_matrix[anchor_idx])[::-1][:bottom_k]
        neg_select = random.randrange(1, len(order))
        neg_idx = int(order[neg_select])
        return (self.data_indices[neg_idx],
                float(self.dist_matrix[anchor_idx][neg_idx]))

    def _sample_random_negative(self, anchor_idx):
        neg_idx = random.randrange(len(self.data_indices))
        return (self.data_indices[neg_idx],
                float(self.dist_matrix[anchor_idx, neg_idx]))

    def _sample_negative(self, anchor_idx, pos_dist):
        neg_data_idx, neg_dist = None, -1.0
        for _ in range(100):
            if self.easy_neg_prob > 0 and random.random() < self.easy_neg_prob:
                neg_data_idx, neg_dist = self._sample_easy_negative(anchor_idx)
            else:
                neg_data_idx, neg_dist = self._sample_random_negative(
                    anchor_idx)
            if neg_dist > pos_dist:
                return neg_data_idx, neg_dist
        logger.warning("could not find negative farther than positive")
        return neg_data_idx, neg_dist

    def __getitem__(self, idx):
        anchor_data_idx = self.data_indices[idx]
        pos_data_idx, pos_dist = self._sample_positive(idx)
        neg_data_idx, neg_dist = self._sample_negative(idx, pos_dist)
        return {
            "anchor": self.dataset[anchor_data_idx],
            "anchor_dist": 0,
            "positive": self.dataset[pos_data_idx],
            "positive_dist": pos_dist,
            "negative": self.dataset[neg_data_idx],
            "negative_dist": neg_dist,
        }
