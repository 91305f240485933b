"""Checkpoint storage abstraction.

Copy of ``dlrover_tpu/common/storage.py`` without the deletion
strategies, which nothing calls.  ``fsspec`` is imported only when an
object-store URL is used (``FsspecStorage.__init__``), so the POSIX tier
needs nothing beyond the standard library.

Reference parity: ``dlrover/python/common/storage.py:24,128,203,231,258``
(CheckpointStorage ABC, PosixDiskStorage), extended
with an fsspec-backed object-store tier (``FsspecStorage``): where the
node-local disk dies with the node, the persistence story is the object
store (SURVEY §5.4 "agent-side async persist to GCS").  Any
fsspec URL works — ``gs://`` (gcsfs), ``s3://``, ``memory://`` (tests)
— selected automatically by :func:`get_checkpoint_storage` from the
checkpoint path's protocol.
"""

import os
import shutil
from abc import ABCMeta, abstractmethod
from typing import List, Optional


class CheckpointStorage(metaclass=ABCMeta):
    """Byte/file-level IO used by the async saver and the load path."""

    @abstractmethod
    def write(self, content, path: str):
        ...

    def write_chunks(self, chunks, path: str):
        """Write an iterable of byte-like chunks as one file. Default
        joins in memory; byte-addressable backends should stream."""
        self.write(b"".join(bytes(c) for c in chunks), path)

    def open_read(self, path: str):
        """A binary file-like handle for streaming reads (the restore
        path fills a preallocated buffer chunk by chunk instead of
        materializing the whole object).  Default buffers the full
        read; real backends override with a true stream.  Raises
        FileNotFoundError on absence."""
        import io

        data = self.read(path, "rb")
        if not data and not self.exists(path):
            raise FileNotFoundError(path)
        return io.BytesIO(data)

    @abstractmethod
    def read(self, path: str, mode: str = "r"):
        ...

    @abstractmethod
    def safe_rmtree(self, dir_path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def safe_makedirs(self, dir_path: str):
        ...

    @abstractmethod
    def safe_move(self, src: str, dst: str):
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]:
        ...

class PosixDiskStorage(CheckpointStorage):
    def write(self, content, path: str):
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())

    def write_chunks(self, chunks, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())

    def read(self, path: str, mode: str = "r"):
        if not os.path.exists(path):
            return "" if "b" not in mode else b""
        with open(path, mode) as f:
            return f.read()

    def open_read(self, path: str):
        return open(path, "rb")

    def safe_rmtree(self, dir_path: str):
        shutil.rmtree(dir_path, ignore_errors=True)

    def safe_remove(self, path: str):
        if os.path.exists(path):
            os.remove(path)

    def safe_makedirs(self, dir_path: str):
        os.makedirs(dir_path, exist_ok=True)

    def safe_move(self, src: str, dst: str):
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.move(src, dst)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))


class FsspecStorage(CheckpointStorage):
    """Object-store checkpoint IO over any fsspec filesystem.

    Commit semantics differ from POSIX: object stores have no atomic
    directory rename, so ``safe_move`` is server-side copy+delete per
    object (non-atomic).  The saver's protocol stays crash-consistent
    anyway because the single-object tracker-file write — which IS
    atomic on GCS/S3 — is the commit point: a reader follows the
    tracker to a fully-populated final dir or ignores the orphaned
    stage prefix.

    ``write_chunks`` streams each chunk straight into the backend's
    buffered upload (multipart on GCS/S3) — a shard-sized shm shard is
    never materialized host-side a second time.
    """

    def __init__(self, protocol_or_url: str, fs=None, **fs_kwargs):
        import fsspec

        if fs is not None:
            self._fs = fs
        else:
            protocol = protocol_or_url.split("://", 1)[0]
            self._fs = fsspec.filesystem(protocol, **fs_kwargs)

    def _p(self, path: str) -> str:
        return self._fs._strip_protocol(path)

    def write(self, content, path: str):
        if isinstance(content, str):
            content = content.encode()
        p = self._p(path)
        with self._fs.open(p, "wb") as f:
            f.write(bytes(content))

    def write_chunks(self, chunks, path: str):
        with self._fs.open(self._p(path), "wb") as f:
            for chunk in chunks:
                f.write(bytes(chunk))

    def open_read(self, path: str):
        # a true stream: fsspec buffers block-sized reads, so the
        # restore path never holds shard-sized bytes besides its own
        # destination buffer
        return self._fs.open(self._p(path), "rb")

    def read(self, path: str, mode: str = "r"):
        p = self._p(path)
        try:
            data = self._fs.cat_file(p)
        except (FileNotFoundError, IsADirectoryError):
            # ONLY genuine absence maps to empty — a transient network
            # error (TimeoutError etc. are OSError subclasses) must
            # raise, or a flaky tracker read would silently restart
            # training from step 0 with checkpoints in the bucket
            return b"" if "b" in mode else ""
        return data if "b" in mode else data.decode()

    def safe_rmtree(self, dir_path: str):
        p = self._p(dir_path)
        try:
            self._fs.rm(p, recursive=True)
        except (FileNotFoundError, OSError):
            pass

    def safe_remove(self, path: str):
        p = self._p(path)
        try:
            self._fs.rm_file(p)
        except (FileNotFoundError, OSError):
            pass

    def safe_makedirs(self, dir_path: str):
        # prefixes need no creation on object stores; makedirs keeps
        # directory-full filesystems (memory://, local) working
        try:
            self._fs.makedirs(self._p(dir_path), exist_ok=True)
        except (OSError, ValueError):
            pass

    def safe_move(self, src: str, dst: str):
        s, d = self._p(src), self._p(dst)
        if not self._fs.exists(s) or self._fs.exists(d):
            return
        self._fs.mv(s, d, recursive=True)

    def exists(self, path: str) -> bool:
        return bool(self._fs.exists(self._p(path)))

    def listdir(self, path: str) -> List[str]:
        p = self._p(path)
        try:
            # bust the dircache: node-0's commit loop polls for done
            # files OTHER nodes write; a cached listing would never
            # show them and every multi-node commit would time out
            self._fs.invalidate_cache(p)
            entries = self._fs.ls(p, detail=False)
        except (FileNotFoundError, OSError):
            return []
        # ls returns full paths (files AND sub-prefixes); callers want
        # names, like os.listdir
        return sorted(
            e.rstrip("/").rsplit("/", 1)[-1]
            for e in entries
            if e.rstrip("/") != p.rstrip("/")
        )


def is_remote_url(path: Optional[str]) -> bool:
    """True when ``path`` carries an fsspec protocol.  file:// counts:
    PosixDiskStorage would treat the URL as a cwd-relative literal
    path; fsspec's LocalFileSystem strips the scheme and resolves it
    correctly.  The single source of truth for every call site that
    branches on URL-ness (storage selection, makedirs skip, shm
    namespace hashing)."""
    return bool(path and "://" in path)


def get_checkpoint_storage(path: Optional[str] = None) -> CheckpointStorage:
    """Storage for ``path``: fsspec when it carries an object-store
    protocol (``gs://…``, ``s3://…``, ``memory://…``), POSIX disk
    otherwise."""
    if is_remote_url(path):
        return FsspecStorage(path)
    return PosixDiskStorage()
