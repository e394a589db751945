"""Storage backends for collections and SBTs: `.zip` (`ZipStorage`), a
directory (`FSStorage`), memory (`MemStorage`), IPFS and Redis.

The port's copy of `sourmash_tpu/sbt_storage.py` (reference
`src/sourmash/sbt_storage.py`: FSStorage:46, ZipStorage:96,
IPFSStorage:418, RedisStorage:457). Zip members are written with a fixed
date, so a collection's bytes depend only on its contents. The IPFS and
Redis backends need their client libraries (`ipfshttpclient`, `redis`)
and raise NotImplementedError without them.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from abc import ABC
from io import BytesIO


class Storage(ABC):
    def __enter__(self):
        return self

    def __exit__(self, type, value, traceback):
        self.close()

    def close(self):
        pass

    def init_args(self):
        return {}

    def can_open(self, location):
        return False

    def save(self, path, content, *, overwrite=False):
        raise NotImplementedError

    def load(self, path):
        raise NotImplementedError


class FSStorage(Storage):
    "Filesystem storage rooted at location/subdir."

    def __init__(self, location, subdir, make_dirs=True):
        self.location = location
        self.subdir = subdir

        if make_dirs:
            fullpath = os.path.join(location, subdir)
            if not os.path.exists(fullpath):
                os.makedirs(fullpath)

    def init_args(self):
        return {"path": self.subdir}

    def save(self, path, content, *, overwrite=False):
        "Save content under path; dedupe identical content, rename if not."
        newpath = path
        fullpath = os.path.join(self.location, self.subdir, path)

        if os.path.exists(fullpath):
            # check for content equality, else add suffix
            with open(fullpath, "rb") as f:
                old_content = f.read()
            if old_content != content:
                newpath = None
                n = 0
                while newpath is None:
                    testpath = f"{fullpath}_{n}"
                    if os.path.exists(testpath):
                        n += 1
                    else:
                        fullpath = testpath
                        newpath = f"{path}_{n}"
        with open(fullpath, "wb") as f:
            f.write(content)
        return newpath

    def load(self, path):
        path = os.path.join(self.location, self.subdir, path)
        with open(path, "rb") as f:
            return f.read()


class ZipStorage(Storage):
    "Zip-file storage (used for .zip signature collections and .sbt.zip)."

    def __init__(self, path, *, mode="r"):
        self.path = os.path.abspath(path)
        self.subdir = ""

        if mode != "r":
            dirname = os.path.dirname(self.path)
            if dirname and not os.path.exists(dirname):
                os.makedirs(dirname)

        # When writing over an EXISTING zip, the original stays open
        # read-only (lazy SBT nodes may still load from it) and new entries
        # go to an in-memory buffer merged in at close() — reference
        # sbt_storage.py:202-226 (_RwZipStorage).
        self._bufferzip = None

        if mode == "r" or (mode == "a" and os.path.exists(self.path)):
            self.zipfile = zipfile.ZipFile(self.path, mode="a" if mode != "r" else "r")
        elif mode == "w" and os.path.exists(self.path):
            self.zipfile = zipfile.ZipFile(self.path, mode="r")
            self._bufferzip = zipfile.ZipFile(BytesIO(), mode="w")
        else:
            self.zipfile = zipfile.ZipFile(self.path, mode="w",
                                           compression=zipfile.ZIP_STORED)

    @staticmethod
    def can_open(location):
        return zipfile.is_zipfile(location)

    def _filenames(self):
        return [zi.filename for zi in self.zipfile.infolist()]

    def _read_any(self, path):
        "Read an entry from the main zip or the write buffer."
        try:
            return self.zipfile.read(path)
        except KeyError:
            if self._bufferzip is not None:
                return self._bufferzip.read(path)
            raise

    def save(self, path, content, *, overwrite=False, compress=False):
        if path is None:
            import hashlib

            path = hashlib.md5(content).hexdigest()
        newpath = path
        existing = set(self._filenames())
        if self._bufferzip is not None:
            existing.update(zi.filename for zi in self._bufferzip.infolist())
        if path in existing and not overwrite:
            old = self._read_any(path)
            if old != content:
                n = 0
                while True:
                    testpath = f"{path}_{n}"
                    if testpath not in existing:
                        newpath = testpath
                        break
                    if self._read_any(testpath) == content:
                        return testpath
                    n += 1
            else:
                return path
        comp = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        target = self._bufferzip if self._bufferzip is not None else self.zipfile
        target.writestr(
            zipfile.ZipInfo(newpath, date_time=(1980, 1, 1, 0, 0, 0)),
            content,
            compress_type=comp,
        )
        return newpath

    def load(self, path):
        if self.zipfile is None:
            # storage was closed (e.g. after a save); reopen for reads
            self.zipfile = zipfile.ZipFile(self.path, mode="r")
        try:
            return self._read_any(path)
        except KeyError:
            pass
        # fall back to subdir-qualified and suffix matches (reference
        # Rust ZipStorage resolves member paths the same way)
        if self.subdir:
            try:
                return self.zipfile.read(f"{self.subdir.rstrip('/')}/{path}")
            except KeyError:
                pass
        suffix = "/" + path
        matches = [n for n in self._filenames() if n.endswith(suffix)]
        if len(matches) == 1:
            return self.zipfile.read(matches[0])
        raise FileNotFoundError(path)

    def init_args(self):
        return {"path": self.path}

    def flush(self):
        pass

    def _merge_buffer(self):
        """Merge buffered writes into the on-disk zip (reference
        sbt_storage.py:341-407 flush): append when no names collide,
        otherwise rewrite the whole archive with buffer entries winning."""
        buffer_names = [zi.filename for zi in self._bufferzip.infolist()]
        if not buffer_names:
            return
        zf_names = set(self._filenames())
        duplicated = zf_names.intersection(buffer_names)

        if not duplicated:
            self.zipfile.close()
            with zipfile.ZipFile(self.path, mode="a",
                                 compression=zipfile.ZIP_STORED) as out:
                for zi in self._bufferzip.infolist():
                    out.writestr(zi, self._bufferzip.read(zi.filename))
            self.zipfile = None
            return

        fd, tmppath = tempfile.mkstemp(dir=os.path.dirname(self.path))
        os.close(fd)
        with zipfile.ZipFile(tmppath, mode="w",
                             compression=zipfile.ZIP_STORED) as out:
            for zi in self.zipfile.infolist():
                if zi.filename not in duplicated:
                    out.writestr(zi, self.zipfile.read(zi.filename))
            for zi in self._bufferzip.infolist():
                out.writestr(zi, self._bufferzip.read(zi.filename))
        self.zipfile.close()
        self.zipfile = None
        os.replace(tmppath, self.path)

    def close(self):
        if self._bufferzip is not None:
            self._merge_buffer()
            self._bufferzip.close()
            self._bufferzip = None
        if self.zipfile is not None:
            self.zipfile.close()
            self.zipfile = None

    def list_sbts(self):
        return [f for f in self._filenames() if f.endswith(".sbt.json")]


class MemStorage(Storage):
    "In-memory storage, mostly for tests."

    def __init__(self):
        self._store = {}

    def save(self, path, content, *, overwrite=False):
        self._store[path] = content
        return path

    def load(self, path):
        return self._store[path]

    def init_args(self):
        return {}

    def _filenames(self):
        return list(self._store)


class IPFSStorage(Storage):
    """Content-addressed node storage over an IPFS daemon (behavior parity:
    reference `sbt_storage.py:418-455`). Requires the optional
    `ipfshttpclient` package; the connection opens at construction."""

    def __init__(self, pin_on_add=True, **kwargs):
        try:
            import ipfshttpclient
        except ImportError as exc:
            raise NotImplementedError(
                "IPFS storage requires the 'ipfshttpclient' library"
            ) from exc

        self.ipfs_args = kwargs
        self.pin_on_add = pin_on_add
        self.api = ipfshttpclient.connect(**self.ipfs_args)

    def save(self, path, content, *, overwrite=False):
        "Add the content; the returned IPFS hash becomes the node's path."
        new_obj = self.api.add_bytes(content)
        if self.pin_on_add:
            self.api.pin.add(new_obj)
        return new_obj

    def load(self, path):
        return self.api.cat(path)

    def init_args(self):
        return self.ipfs_args

    def __exit__(self, type, value, traceback):
        # TODO: do nothing for now; can we cache any of the data transferred?
        pass


class RedisStorage(Storage):
    """Key/value node storage in a Redis server (behavior parity:
    reference `sbt_storage.py:457-478`). Requires the optional `redis`
    package."""

    def __init__(self, **kwargs):
        try:
            import redis
        except ImportError as exc:
            raise NotImplementedError(
                "Redis storage requires the 'redis' library"
            ) from exc

        self.redis_args = kwargs
        self.conn = redis.Redis(**self.redis_args)

    def save(self, path, content, *, overwrite=False):
        if not isinstance(content, bytes):
            content = bytes(content)
        self.conn.set(path, content)
        return path

    def load(self, path):
        return self.conn.get(path)

    def init_args(self):
        return self.redis_args

    def __exit__(self, type, value, traceback):
        pass
