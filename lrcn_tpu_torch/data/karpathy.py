"""Karpathy precomputed-feature import (a copy of
``lrcn_tpu/data/karpathy.py``, built on this package's ``FeatureStore``).

The reference's ``feature_extractor.jl`` re-keys Karpathy's Flickr30k
``vgg_feats.mat`` (a 4096 x N feature matrix, column ``imgid+1`` per image)
by the integer Flickr image id taken from ``dataset.json``'s filenames,
then merges any per-image JLD files, and saves one combined dict
(feature_extractor.jl:14-51).  Here the same flow produces a
:class:`~lrcn_tpu_torch.data.feature_store.FeatureStore`.  scipy is
imported inside the function, so importing this module needs none.
"""

from __future__ import annotations

import json
import os

import numpy as np

from lrcn_tpu_torch.data.feature_store import FeatureStore, l1_normalize


def import_karpathy(vgg_feats_mat: str, dataset_json: str, *,
                    normalize: bool = True,
                    store: FeatureStore | None = None) -> FeatureStore:
    """Build a FeatureStore from Karpathy's vgg_feats.mat + dataset.json.

    Features are column-indexed by ``imgid`` (0-based; the reference adds 1
    for Julia's 1-based indexing, feature_extractor.jl:27); the store key is
    the integer stem of ``filename`` (feature_extractor.jl:28-29).

    ``normalize`` L1-normalizes rows (the reference's decoder expects
    pre-normalized ``featsn`` feature files; lrcn.jl:121-123, :597).
    """
    from scipy.io import loadmat

    mat = loadmat(vgg_feats_mat)
    feats = np.asarray(mat["feats"], np.float32)     # (4096, N)
    with open(dataset_json) as f:
        images = json.load(f)["images"]

    if store is None:
        store = FeatureStore(dim=feats.shape[0], normalized=normalize)
    for image in images:
        image_id = int(os.path.splitext(image["filename"])[0])
        if image_id in store:   # get! semantics: first writer wins
            continue
        row = feats[:, int(image["imgid"])]
        if normalize:
            row = l1_normalize(row[None])[0]
        store.add(image_id, row)
    return store
