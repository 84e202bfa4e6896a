"""Filesystems for fleet checkpoints and data: the port of
`paddle_tpu/distributed/fleet/utils/fs.py`.

`FS` is the interface; `LocalFS` is built on os/shutil; `HDFSClient`
runs `hadoop fs` subcommands through subprocess with timeouts — it works
where a Hadoop install is present (`hadoop_home=` or $HADOOP_HOME) and
otherwise raises an ExecuteError that names the missing install.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    """Abstract filesystem. Subclasses implement every
    operation; `need_upload_download()` says whether paths live off-host
    (HDFS) or are directly addressable (local)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def upload_dir(self, local_dir, dest_dir):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem."""

    def ls_dir(self, fs_path):
        """Returns ([dirs], [files]) directly under fs_path."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if self.is_exist(dst_path):
            if not overwrite:
                raise FSFileExistsError(dst_path)
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        """Subdirectory names only (ref semantics)."""
        return self.ls_dir(fs_path)[0]

    # upload/download degenerate to copies for a local fs
    def upload(self, local_path, fs_path):
        self._copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self._copy(fs_path, local_path)

    def upload_dir(self, local_dir, dest_dir):
        shutil.copytree(local_dir, dest_dir, dirs_exist_ok=True)

    def _copy(self, src, dst):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_dir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
            shutil.copy2(src, dst)


class HDFSClient(FS):
    """HDFS via the hadoop CLI (`hadoop fs`). Requires a hadoop install: pass `hadoop_home` or set
    $HADOOP_HOME. Every call raises ExecuteError/FSTimeOut with the
    command and output on failure — never a silent no-op."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60,
                 sleep_inter=1):
        self._hadoop_home = hadoop_home or os.environ.get("HADOOP_HOME")
        self._timeout = time_out
        self._sleep = sleep_inter
        self._config_args = []
        for k, v in (configs or {}).items():
            self._config_args += ["-D", f"{k}={v}"]

    def _bin(self):
        if not self._hadoop_home:
            raise ExecuteError(
                "HDFSClient needs a hadoop install: pass hadoop_home= or "
                "set $HADOOP_HOME (or use LocalFS over a mounted/NFS/"
                "object-store path)")
        return os.path.join(self._hadoop_home, "bin", "hadoop")

    def _run(self, *args, check=True):
        cmd = [self._bin(), "fs"] + self._config_args + list(args)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self._timeout)
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(f"{' '.join(cmd)} timed out "
                            f"after {self._timeout}s") from e
        if check and r.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)} failed "
                               f"(rc={r.returncode}): {r.stderr[:500]}")
        return r

    def need_upload_download(self):
        return True

    def is_exist(self, fs_path):
        return self._run("-test", "-e", fs_path, check=False).returncode == 0

    def is_file(self, fs_path):
        return self._run("-test", "-f", fs_path, check=False).returncode == 0

    def is_dir(self, fs_path):
        return self._run("-test", "-d", fs_path, check=False).returncode == 0

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        out = self._run("-ls", fs_path).stdout
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run("-rm", "-r", "-f", fs_path)

    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    def upload_dir(self, local_dir, dest_dir):
        self._run("-put", "-f", local_dir, dest_dir)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        self._run("-touchz", fs_path)

    def rename(self, fs_src_path, fs_dst_path):
        self._run("-mv", fs_src_path, fs_dst_path)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=True):
        if test_exists:
            if not self.is_exist(fs_src_path):
                raise FSFileNotExistsError(fs_src_path)
            if self.is_exist(fs_dst_path):
                if not overwrite:
                    raise FSFileExistsError(fs_dst_path)
                self.delete(fs_dst_path)
        start = time.time()
        while True:
            try:
                self._run("-mv", fs_src_path, fs_dst_path)
                return
            except ExecuteError:
                if time.time() - start > self._timeout:
                    raise
                time.sleep(self._sleep)
