"""Remote (streaming) datasets (port of ``cvd_tpu/data/remote.py``).

The reference's ``dataset_realestate10k_remote`` / ``dataset_webvid10m_remote``
are absent from its release (train_epi_control.py:79-89); only the call-site
contract survives: the local datasets' items, from data in remote storage.
Each clip's files stream from any URL scheme ``urllib`` opens (https, gs
through signed URLs, file) into a local cache directory on first touch; the
port's local datasets then serve the item.

``_fetch`` retries transient failures with exponential backoff, resumes a
partial download through HTTP Range from the ``.tmp`` a failed run left,
fails at once on a hard 4xx, and sends the headers of two environment
variables (the JAX package's, so one deployment serves both):
  CVD_TPU_REMOTE_TOKEN    -> ``Authorization: Bearer <token>``
  CVD_TPU_REMOTE_HEADERS  -> a JSON dict of extra headers

Layout under ``base_url`` (the local roots'):
    <base>/RealEstate10K/<split>/index.txt        one clip name per line
    <base>/RealEstate10K/<split>/<clip>.txt       pose files
    <base>/dataset/<split>/<clip>.mp4             videos
    <base>/annotation_json/<split>_captions.json
WebVid:
    <base>/index.txt ("<clip> <frames>" lines), <base>/captions.json,
    <base>/videos/<clip>/<i:04d>.png
"""
from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

FETCH_ATTEMPTS = 3
BACKOFF_SECONDS = 1.0


def _auth_headers() -> Dict[str, str]:
    headers: Dict[str, str] = {}
    token = os.environ.get("CVD_TPU_REMOTE_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    extra = os.environ.get("CVD_TPU_REMOTE_HEADERS")
    if extra:
        headers.update(json.loads(extra))
    return headers


def _retryable(e: BaseException) -> bool:
    """Transient transport failures retry; a hard 4xx (missing clip, bad
    auth) fails at once."""
    if isinstance(e, urllib.error.HTTPError):
        return e.code in (408, 425, 429) or e.code >= 500
    return isinstance(e, (urllib.error.URLError, ConnectionError, TimeoutError, OSError))


def _fetch(url: str, dest: str) -> str:
    """Download ``url`` to ``dest`` unless it is there already. Atomic
    through ``dest + ".tmp"`` and a rename; a partial ``.tmp`` resumes with
    a Range request (appended on a 206, rewritten otherwise)."""
    if os.path.exists(dest):
        return dest
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".tmp"
    last: Optional[BaseException] = None
    for attempt in range(FETCH_ATTEMPTS):
        offset = os.path.getsize(tmp) if os.path.exists(tmp) else 0
        headers = _auth_headers()
        if offset:
            headers["Range"] = f"bytes={offset}-"
        try:
            with urllib.request.urlopen(urllib.request.Request(url, headers=headers)) as r:
                resumed = offset and getattr(r, "status", None) == 206
                with open(tmp, "ab" if resumed else "wb") as f:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
            os.replace(tmp, dest)
            return dest
        except urllib.error.HTTPError as e:
            if offset and e.code in (416, 501):
                os.remove(tmp)     # the server refused the Range: start clean
            elif not _retryable(e):
                raise
            last = e
        except Exception as e:  # noqa: BLE001 - _retryable decides, the rest re-raises
            if not _retryable(e):
                raise
            last = e
        if attempt < FETCH_ATTEMPTS - 1:
            time.sleep(BACKOFF_SECONDS * (2 ** attempt))
    raise IOError(f"fetch failed after {FETCH_ATTEMPTS} attempts: {url}") from last


def _join(base: str, *parts: str) -> str:
    return base.rstrip("/") + "/" + "/".join(urllib.parse.quote(p) for p in parts)


class RealEstate10KPoseFoldedRemote:
    """Streaming RealEstate10K folded pairs. The split's index and captions
    are fetched at construction; a clip's pose file and mp4 at its first
    ``__getitem__``, after which it is appended to the one local dataset
    over the cache (no re-scan, and its frame-sampling rng is never
    reseeded)."""

    def __init__(self, base_url: str, cache_dir: Optional[str] = None, split: str = "train",
                 sample_stride: int = 2, sample_n_frames: int = 16, sample_size: int = 256,
                 seed: Optional[int] = None):
        from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded

        self.base_url = base_url
        self.split = split
        self.cache = cache_dir or os.path.expanduser("~/.cache/cvd_tpu_data/re10k")
        idx = _fetch(_join(base_url, "RealEstate10K", split, "index.txt"),
                     os.path.join(self.cache, "RealEstate10K", split, "index.txt"))
        with open(idx) as f:
            self.clips: List[str] = [line.strip() for line in f if line.strip()]
        captions = _fetch(_join(base_url, "annotation_json", f"{split}_captions.json"),
                          os.path.join(self.cache, "annotation_json", f"{split}_captions.json"))
        with open(captions) as f:
            self._captions = json.load(f)
        self._local = RealEstate10KPoseFolded(
            root_path=self.cache, sample_stride=sample_stride, sample_n_frames=sample_n_frames,
            sample_size=sample_size, seed=seed)
        self._name2idx: Dict[str, int] = {e["clip_name"]: i
                                          for i, e in enumerate(self._local.dataset)}

    def __len__(self) -> int:
        return len(self.clips)

    def _ensure(self, clip: str) -> None:
        pose = _fetch(_join(self.base_url, "RealEstate10K", self.split, clip + ".txt"),
                      os.path.join(self.cache, "RealEstate10K", self.split, clip + ".txt"))
        _fetch(_join(self.base_url, "dataset", self.split, clip + ".mp4"),
               os.path.join(self.cache, "dataset", self.split, clip + ".mp4"))
        if clip not in self._name2idx:
            caption = self._captions.get(clip + ".mp4")
            if caption is None:
                raise KeyError(f"clip {clip} has no caption in the remote "
                               f"{self.split}_captions.json")
            self._local.dataset.append({
                "clip_name": clip, "pose_file": pose, "caption": caption[0],
                "clip_path": os.path.join(self.cache, "dataset", self.split, clip)})
            self._name2idx[clip] = len(self._local.dataset) - 1

    def __getitem__(self, idx: int) -> dict:
        clip = self.clips[idx % len(self.clips)]
        self._ensure(clip)
        return self._local[self._name2idx[clip]]


class WebVid10MRemote:
    """Streaming WebVid-style unposed clips: a clip's frames are fetched at
    its first ``__getitem__`` and appended to the local dataset."""

    def __init__(self, base_url: str, cache_dir: Optional[str] = None,
                 sample_n_frames: int = 16, sample_size: int = 256,
                 seed: Optional[int] = None):
        from cvd_tpu_torch.data.webvid import WebVidFolded

        self.base_url = base_url
        self.cache = cache_dir or os.path.expanduser("~/.cache/cvd_tpu_data/webvid")
        idx = _fetch(_join(base_url, "index.txt"), os.path.join(self.cache, "index.txt"))
        with open(idx) as f:
            self.clips = [line.strip().split() for line in f if line.strip()]
        captions = _fetch(_join(base_url, "captions.json"),
                          os.path.join(self.cache, "captions.json"))
        with open(captions) as f:
            self._captions = json.load(f)
        self._local = WebVidFolded(root_path=self.cache, sample_n_frames=sample_n_frames,
                                   sample_size=sample_size, seed=seed)
        self._name2idx: Dict[str, int] = {os.path.basename(e["path"]): i
                                          for i, e in enumerate(self._local.clips)}

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> dict:
        name, n_frames = self.clips[idx % len(self.clips)][:2]
        for i in range(int(n_frames)):
            _fetch(_join(self.base_url, "videos", name, f"{i:04d}.png"),
                   os.path.join(self.cache, "videos", name, f"{i:04d}.png"))
        if name not in self._name2idx:
            self._local.clips.append({"path": os.path.join(self.cache, "videos", name),
                                      "caption": self._captions.get(name, name)})
            self._name2idx[name] = len(self._local.clips) - 1
        return self._local[self._name2idx[name]]
