"""Dataset acquisition: MS-COCO 2014 + Flickr30k (+ Karpathy features);
a copy of ``lrcn_tpu/data/download.py`` (standard library only).

Equivalent of the reference's ``download_data.sh`` / ``karpathy_features.sh``
as a resumable Python fetcher.  Files already present are skipped, archives
are extracted next to themselves.

The reference scripts' 2016-era hosts are dead (``msvocds.blob.core.
windows.net`` no longer resolves; download_data.sh:1-22); COCO moved to
``images.cocodataset.org``.  Flickr30k proper is gated behind a form at
the UIUC page, so its URL list stays on the original host and failures
point the user at the form.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
import zipfile

# COCO's current host (the reference's msvocds.blob URLs are dead).
COCO_URLS = [
    "http://images.cocodataset.org/zips/train2014.zip",
    "http://images.cocodataset.org/zips/val2014.zip",
    "http://images.cocodataset.org/annotations/"
    "annotations_trainval2014.zip",
]
# Flickr30k requires a signed form (https://shannon.cs.illinois.edu/
# DenotationGraph/); these are the reference's URLs (download_data.sh:9-13).
FLICKR_URLS = [
    "http://shannon.cs.illinois.edu/DenotationGraph/data/"
    "flickr30k-images.tar",
    "http://shannon.cs.illinois.edu/DenotationGraph/data/flickr30k.tar.gz",
]
KARPATHY_URLS = [
    "https://cs.stanford.edu/people/karpathy/deepimagesent/flickr30k.zip",
]


def fetch(url: str, dest_dir: str) -> str:
    """Download ``url`` into ``dest_dir`` unless already present.

    Downloads to a ``.part`` file and renames on success, so an
    interrupted fetch is never mistaken for a finished archive on retry.
    """
    os.makedirs(dest_dir, exist_ok=True)
    path = os.path.join(dest_dir, os.path.basename(url))
    if not os.path.exists(path):
        print(f"downloading {url}")
        part = path + ".part"
        try:
            urllib.request.urlretrieve(url, part)
        except Exception as e:
            if os.path.exists(part):
                os.remove(part)
            if "DenotationGraph" in url:
                raise RuntimeError(
                    f"could not fetch {url}: {e}. Flickr30k is gated "
                    "behind a signup form — request access at "
                    "https://shannon.cs.illinois.edu/DenotationGraph/ and "
                    "place the archives in "
                    f"{dest_dir} manually") from e
            raise
        os.replace(part, path)
    return path


def extract(path: str, dest_dir: str) -> None:
    """Extract a .zip/.tar/.tar.gz archive into ``dest_dir``."""
    print(f"extracting {os.path.basename(path)}")
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest_dir)
    elif path.endswith((".tar", ".tar.gz", ".tgz")):
        with tarfile.open(path) as t:
            t.extractall(dest_dir, filter="data")
    else:
        raise ValueError(f"unknown archive type: {path}")


def download_dataset(which: str, root: str = "data") -> None:
    """``which`` in {"coco", "flickr", "karpathy"}."""
    urls = {"coco": COCO_URLS, "flickr": FLICKR_URLS,
            "karpathy": KARPATHY_URLS}[which]
    dest = os.path.join(root, {"coco": "MsCoCo", "flickr": "Flickr30k",
                               "karpathy": "Flickr30k/karpathy"}[which])
    for url in urls:
        extract(fetch(url, dest), dest)
