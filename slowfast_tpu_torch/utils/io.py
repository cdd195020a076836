"""Pluggable file IO (counterpart of slowfast_tpu/utils/io.py): the
reference's iopath ``pathmgr`` (reference slowfast/utils/env.py:9-17, which
routes every checkpoint / list-file / log write through a PathManager so
remote URIs — GCS buckets, internal blob stores — work everywhere local
paths do).

All framework IO (checkpoints, dataset list files, json stats, log files)
goes through the module-level :data:`pathmgr`. A URI scheme is routed to
whichever :class:`PathHandler` was registered for its prefix; everything
else falls through to the local filesystem. Registering a handler is one
call:

    from slowfast_tpu_torch.utils.io import pathmgr
    pathmgr.register_handler("gs://", MyGcsHandler())

If ``fsspec`` is importable, any ``scheme://`` URI without an explicit
handler is bridged to ``fsspec.open`` automatically, so ``gs://`` / ``s3://``
checkpoints work out of the box wherever the corresponding fsspec backend
is installed.

Paths handed to native code (cv2's video and JPEG decoders read local
files) intentionally bypass this layer — remote *datasets* are staged by
the loader, not streamed per-read.
"""

import io as _stdio
import os
import shutil
import threading
from typing import Dict, List


class PathHandler:
    """Interface one storage backend implements.

    Only ``_open`` is mandatory; the rest have conservative defaults that
    raise, so a partial backend fails loudly rather than silently
    misbehaving.
    """

    def _open(self, path: str, mode: str = "r", **kwargs):
        raise NotImplementedError

    def _exists(self, path: str) -> bool:
        raise NotImplementedError

    def _isdir(self, path: str) -> bool:
        raise NotImplementedError

    def _ls(self, path: str) -> List[str]:
        raise NotImplementedError

    def _mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def _rm(self, path: str) -> None:
        raise NotImplementedError

    def _replace(self, src: str, dst: str) -> None:
        """Atomically (best effort) publish ``src`` at ``dst``.

        Remote stores usually lack rename; the default copies then deletes,
        which still gives the checkpoint writer's contract that ``dst``
        never exists truncated (the copy is only visible once complete on
        stores with atomic-put semantics).
        """
        with self._open(src, "rb") as fsrc, self._open(dst, "wb") as fdst:
            shutil.copyfileobj(fsrc, fdst)
        self._rm(src)


class LocalPathHandler(PathHandler):
    """Plain local filesystem (the default route)."""

    def _open(self, path, mode="r", **kwargs):
        return open(path, mode, **kwargs)

    def _exists(self, path):
        return os.path.exists(path)

    def _isdir(self, path):
        return os.path.isdir(path)

    def _ls(self, path):
        return os.listdir(path)

    def _mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def _rm(self, path):
        os.remove(path)

    def _replace(self, src, dst):
        os.replace(src, dst)  # true atomic rename


class FsspecPathHandler(PathHandler):
    """Bridge any ``scheme://`` URI to fsspec when it is importable."""

    def __init__(self):
        import fsspec  # deferred: optional dependency

        self._fsspec = fsspec

    def _fs(self, path):
        fs, p = self._fsspec.core.url_to_fs(path)
        return fs, p

    def _open(self, path, mode="r", **kwargs):
        return self._fsspec.open(path, mode, **kwargs).open()

    def _exists(self, path):
        fs, p = self._fs(path)
        return fs.exists(p)

    def _isdir(self, path):
        fs, p = self._fs(path)
        return fs.isdir(p)

    def _ls(self, path):
        fs, p = self._fs(path)
        # detail=False: names, not the info dicts some filesystems list by
        # default (the JAX package's call omits it and fails on them).
        return [name.rstrip("/").rsplit("/", 1)[-1] for name in fs.ls(p, detail=False)]

    def _mkdirs(self, path):
        fs, p = self._fs(path)
        fs.makedirs(p, exist_ok=True)

    def _rm(self, path):
        fs, p = self._fs(path)
        fs.rm(p)


class MemoryPathHandler(PathHandler):
    """In-memory blob store for a URI prefix.

    Serves two jobs: the mock remote backend the checkpoint round-trip
    tests run against, and a reference implementation of the handler
    contract (exercises the copy+delete ``_replace`` default path remote
    stores take).
    """

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _open(self, path, mode="r", **kwargs):
        if "w" in mode or "a" in mode:
            store, lock = self._blobs, self._lock
            binary = "b" in mode

            class _Writer(_stdio.BytesIO):
                def close(self):
                    with lock:
                        prev = store.get(path, b"") if "a" in mode else b""
                        store[path] = prev + self.getvalue()
                    super().close()

            buf = _Writer()
            return buf if binary else _stdio.TextIOWrapper(buf)
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(path)
            data = self._blobs[path]
        return (
            _stdio.BytesIO(data)
            if "b" in mode
            else _stdio.StringIO(data.decode())
        )

    def _exists(self, path):
        with self._lock:
            return path in self._blobs or self._isdir(path)

    def _isdir(self, path):
        prefix = path.rstrip("/") + "/"
        return any(k.startswith(prefix) for k in self._blobs)

    def _ls(self, path):
        prefix = path.rstrip("/") + "/"
        names = {
            k[len(prefix):].split("/", 1)[0]
            for k in self._blobs
            if k.startswith(prefix)
        }
        return sorted(names)

    def _mkdirs(self, path):
        pass  # blob stores have no directories

    def _rm(self, path):
        with self._lock:
            del self._blobs[path]


class PathManager:
    """Longest-prefix router from URI to :class:`PathHandler`."""

    def __init__(self):
        self._handlers: Dict[str, PathHandler] = {}
        self._local = LocalPathHandler()

    def register_handler(self, prefix: str, handler: PathHandler) -> None:
        if "://" not in prefix:
            raise ValueError(f"handler prefix needs a scheme: {prefix!r}")
        self._handlers[prefix] = handler

    def _route(self, path: str) -> PathHandler:
        best = None
        for prefix, handler in self._handlers.items():
            if path.startswith(prefix) and (
                best is None or len(prefix) > len(best[0])
            ):
                best = (prefix, handler)
        if best is not None:
            return best[1]
        if "://" in path.split("/", 1)[0] or "://" in path[:12]:
            handler = self._try_fsspec()
            if handler is not None:
                return handler
            raise ValueError(
                f"no PathHandler registered for {path!r} and fsspec is not "
                "available; register one with pathmgr.register_handler()"
            )
        return self._local

    def _try_fsspec(self):
        if not hasattr(self, "_fsspec_handler"):
            try:
                self._fsspec_handler = FsspecPathHandler()
            except ImportError:
                self._fsspec_handler = None
        return self._fsspec_handler

    # -- public API (the subset of iopath's PathManager the repo uses) --
    def open(self, path, mode="r", **kwargs):
        return self._route(path)._open(path, mode, **kwargs)

    def exists(self, path) -> bool:
        return self._route(path)._exists(path)

    def isdir(self, path) -> bool:
        return self._route(path)._isdir(path)

    def ls(self, path) -> List[str]:
        return self._route(path)._ls(path)

    def mkdirs(self, path) -> None:
        self._route(path)._mkdirs(path)

    def rm(self, path) -> None:
        self._route(path)._rm(path)

    def replace(self, src, dst) -> None:
        hs, hd = self._route(src), self._route(dst)
        if hs is hd:
            hs._replace(src, dst)
        else:  # cross-backend publish: copy bytes, then drop the source
            with hs._open(src, "rb") as fsrc, hd._open(dst, "wb") as fdst:
                shutil.copyfileobj(fsrc, fdst)
            hs._rm(src)


pathmgr = PathManager()
