"""fleet.utils — the filesystems and the KV rendezvous server."""
from . import fs  # noqa: F401
from .fs import (  # noqa: F401
    ExecuteError, FS, FSFileExistsError, FSFileNotExistsError,
    FSShellCmdAborted, FSTimeOut, HDFSClient, LocalFS,
)
from .http_server import KVClient, KVHTTPServer, KVServer  # noqa: F401

__all__ = ["LocalFS", "HDFSClient", "FS", "ExecuteError",
           "FSFileExistsError", "FSFileNotExistsError", "FSTimeOut",
           "FSShellCmdAborted", "KVServer", "KVClient", "KVHTTPServer"]
