"""Where the Spark estimators keep their intermediate Parquet data,
checkpoints and logs (the port's copy of
``horovod_tpu/spark/common/store.py``, after upstream Horovod's
``spark/common/store.py``). ``LocalStore`` is a plain filesystem;
``HDFSStore`` and ``S3Store`` go through ``pyarrow.fs`` and connect at
their first read or write.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Optional


class Store:
    """Interface (parity: ``store.py`` Store)."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write_text(self, path: str, text: str) -> None:
        raise NotImplementedError

    def is_parquet_dataset(self, path: str) -> bool:
        raise NotImplementedError

    def get_parquet_dataset(self, path: str):
        raise NotImplementedError

    def get_train_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_val_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_test_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def saving_runs(self) -> bool:
        return True

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        if prefix_path.startswith("hdfs://"):
            return HDFSStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith("s3://"):
            return S3Store(prefix_path, *args, **kwargs)
        return LocalStore(prefix_path, *args, **kwargs)


class LocalStore(Store):
    """Filesystem store (parity: ``store.py`` LocalStore)."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None,
                 save_runs: bool = True):
        self.prefix_path = prefix_path
        self._train_path = train_path or os.path.join(
            prefix_path, "intermediate_train_data")
        self._val_path = val_path or os.path.join(
            prefix_path, "intermediate_val_data")
        self._test_path = test_path or os.path.join(
            prefix_path, "intermediate_test_data")
        self._runs_path = runs_path or os.path.join(prefix_path, "runs")
        self._save_runs = save_runs
        os.makedirs(prefix_path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_text(self, path: str, text: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)

    def is_parquet_dataset(self, path: str) -> bool:
        return os.path.isdir(path) and any(
            n.endswith(".parquet") for n in os.listdir(path))

    def get_parquet_dataset(self, path: str):
        import pyarrow.parquet as pq  # optional dependency

        return pq.ParquetDataset(path)

    def _suffixed(self, base: str, idx) -> str:
        return base if idx is None else f"{base}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._suffixed(self._train_path, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._suffixed(self._val_path, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._suffixed(self._test_path, idx)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self._runs_path, run_id, "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self._runs_path, run_id, "logs")

    def saving_runs(self) -> bool:
        return self._save_runs

    def clear(self) -> None:
        with contextlib.suppress(FileNotFoundError):
            shutil.rmtree(self.prefix_path)


class _FilesystemStore(Store):
    """Shared implementation over a ``pyarrow.fs.FileSystem`` (the role of
    upstream Horovod's HDFSStore pyarrow client). Path
    layout mirrors LocalStore; IO goes through the pyarrow filesystem so
    the same code serves HDFS and S3. The filesystem connects lazily —
    constructing a store (and computing its paths) needs no cluster."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None,
                 save_runs: bool = True):
        self.prefix_path = prefix_path.rstrip("/")
        join = "/".join
        self._train_path = train_path or join(
            [self.prefix_path, "intermediate_train_data"])
        self._val_path = val_path or join(
            [self.prefix_path, "intermediate_val_data"])
        self._test_path = test_path or join(
            [self.prefix_path, "intermediate_test_data"])
        self._runs_path = runs_path or join([self.prefix_path, "runs"])
        self._save_runs = save_runs
        self._fs = None

    # -- subclass hook -------------------------------------------------------

    def _connect(self):
        """Return (pyarrow.fs.FileSystem, path-stripper)."""
        raise NotImplementedError

    def _fs_and_path(self, path: str):
        if self._fs is None:
            self._fs = self._connect()
        return self._fs, self._strip(path)

    # -- Store interface over pyarrow.fs -------------------------------------

    def exists(self, path: str) -> bool:
        from pyarrow.fs import FileType

        fs, p = self._fs_and_path(path)
        return fs.get_file_info(p).type != FileType.NotFound

    def read(self, path: str) -> bytes:
        fs, p = self._fs_and_path(path)
        with fs.open_input_stream(p) as f:
            return f.read()

    def write_text(self, path: str, text: str) -> None:
        fs, p = self._fs_and_path(path)
        parent = p.rsplit("/", 1)[0]
        fs.create_dir(parent, recursive=True)
        with fs.open_output_stream(p) as f:
            f.write(text.encode())

    def is_parquet_dataset(self, path: str) -> bool:
        from pyarrow.fs import FileSelector, FileType

        fs, p = self._fs_and_path(path)
        info = fs.get_file_info(p)
        if info.type != FileType.Directory:
            return False
        return any(i.path.endswith(".parquet")
                   for i in fs.get_file_info(FileSelector(p)))

    def get_parquet_dataset(self, path: str):
        import pyarrow.parquet as pq

        fs, p = self._fs_and_path(path)
        return pq.ParquetDataset(p, filesystem=fs)

    def _suffixed(self, base: str, idx) -> str:
        return base if idx is None else f"{base}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._suffixed(self._train_path, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._suffixed(self._val_path, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._suffixed(self._test_path, idx)

    def get_checkpoint_path(self, run_id: str) -> str:
        return "/".join([self._runs_path, run_id, "checkpoint"])

    def get_logs_path(self, run_id: str) -> str:
        return "/".join([self._runs_path, run_id, "logs"])

    def saving_runs(self) -> bool:
        return self._save_runs


class HDFSStore(_FilesystemStore):
    """HDFS store (parity: ``store.py:280`` HDFSStore) over
    ``pyarrow.fs.HadoopFileSystem``. Fully functional where libhdfs is
    present; path construction and layout work without a cluster, and
    the first actual IO raises pyarrow's descriptive error when the
    Hadoop client libraries are missing."""

    def __init__(self, prefix_path: str, host: Optional[str] = None,
                 port: Optional[int] = None, user: Optional[str] = None,
                 **kwargs):
        super().__init__(prefix_path, **kwargs)
        rest = prefix_path[len("hdfs://"):]
        authority = rest.split("/", 1)[0]
        if host is None and authority and ":" in authority:
            host, _, port_s = authority.partition(":")
            port = port or int(port_s)
        elif host is None and authority:
            host = authority
        self._host = host or "default"
        self._port = port or 0
        self._user = user

    def _strip(self, path: str) -> str:
        if path.startswith("hdfs://"):
            rest = path[len("hdfs://"):]
            return "/" + rest.split("/", 1)[1] if "/" in rest else "/"
        return path

    def _connect(self):
        from pyarrow.fs import HadoopFileSystem

        return HadoopFileSystem(self._host, self._port, user=self._user)


class S3Store(_FilesystemStore):
    """S3 store over ``pyarrow.fs.S3FileSystem`` (upstream Horovod gates S3
    behind fsspec the same way; here pyarrow's native client serves)."""

    def _strip(self, path: str) -> str:
        return path[len("s3://"):] if path.startswith("s3://") else path

    def _connect(self):
        from pyarrow.fs import S3FileSystem

        return S3FileSystem()
