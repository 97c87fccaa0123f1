"""Asset sources: where assets load from / save to.

Copy of the reference's ``utils/source.py``: ``tests/test_torch_viewer.py``
holds its results equal to the reference's.

Capability parity with the reference's ``Source``/``Directory`` model
(reference: src/plugins/asset/source.rs:73-212):

- ``PathSource`` — local filesystem,
- ``UrlSource`` — HTTP(S) GET; a 404 maps to ``FileNotFoundError`` like
  source.rs:193-198 (so missing cells enter the negative cache),
- ``NoSource`` — in-memory only assets (new clouds before "save at"),
- ``Directory.join`` — resolve a relative asset path against a root
  (rejecting ``..``/absolute escapes like source.rs:145-152).

The WASM FileSystem-Access directory flavor has no equivalent here; a
local directory covers that capability.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path


class SourceError(IOError):
    pass


@dataclass(frozen=True)
class NoSource:
    def load(self) -> bytes:
        raise SourceError("asset has no source")

    def save(self, data: bytes) -> None:
        raise SourceError("asset has no source")


@dataclass(frozen=True)
class PathSource:
    path: Path

    def load(self) -> bytes:
        return Path(self.path).read_bytes()

    def save(self, data: bytes) -> None:
        path = Path(self.path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)


@dataclass(frozen=True)
class UrlSource:
    url: str

    def load(self) -> bytes:
        try:
            with urllib.request.urlopen(self.url) as resp:
                return resp.read()
        except urllib.error.HTTPError as err:
            if err.code == 404:  # NotFound -> negative cache (source.rs:193-198)
                raise FileNotFoundError(self.url) from err
            raise SourceError(f"GET {self.url}: {err}") from err

    def save(self, data: bytes) -> None:
        raise SourceError("URL sources are read-only")


Source = NoSource | PathSource | UrlSource


@dataclass(frozen=True)
class Directory:
    """A root that relative asset paths resolve against."""

    root: Path | str

    def join(self, relative: str) -> Source:
        if isinstance(self.root, str) and "://" in self.root:
            if ".." in relative.split("/"):
                raise SourceError(f"path escape rejected: {relative}")
            return UrlSource(self.root.rstrip("/") + "/" + relative)
        rel = Path(relative)
        if rel.is_absolute() or ".." in rel.parts:  # source.rs:145-152
            raise SourceError(f"path escape rejected: {relative}")
        return PathSource(Path(self.root) / rel)
