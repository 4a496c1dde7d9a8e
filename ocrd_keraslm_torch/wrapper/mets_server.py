"""METS server: share one workspace's METS across processes.

Counterpart of ``ocrd_keraslm_tpu/wrapper/mets_server.py`` (a
functional equivalent of OCR-D core's ``OcrdMetsServer``, which the
reference plumbs through ``--mets-server-url`` to run page-parallel
processing against a METS served from a second process), over the
port's standalone :mod:`ocrd_keraslm_torch.wrapper.mets` object model
and the standard library only:

* :class:`MetsServer` owns the authoritative :class:`Mets` of one
  workspace and serialises every mutation (``add_file``/``save``)
  behind a lock, so N page-parallel workers write results without METS
  races;
* :class:`RemoteWorkspace` stands in for :class:`Workspace` inside
  :class:`KerasRate`: reads go to a local snapshot (``refresh()``
  re-pulls), writes are forwarded over the socket;
* :func:`serve` is the target of a server process: it imports nothing
  but this module's package, so a process started with the ``spawn``
  method (``multiprocessing.get_context('spawn')``) stays light.

Transport: newline-delimited JSON over a unix stream socket (the
``--mets-server-url`` value is the socket path, as in OCR-D's UDS
mode).
"""
from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import threading
import time
from typing import Optional

from .mets import Mets, MetsFile, Workspace

LOG = logging.getLogger(__name__)

_MAXLINE = 64 * 1024 * 1024


def _mets_to_dict(mets: Mets) -> dict:
    return {
        'unique_identifier': mets.unique_identifier,
        'page_ids': list(mets.page_ids),
        'file_groups': {
            grp: [{'ID': f.ID, 'fileGrp': f.fileGrp,
                   'mimetype': f.mimetype,
                   'local_filename': f.local_filename,
                   'pageId': f.pageId} for f in files]
            for grp, files in mets.file_groups.items()},
    }


def _mets_from_dict(d: dict) -> Mets:
    mets = Mets(unique_identifier=d.get('unique_identifier'),
                page_ids=list(d.get('page_ids', [])))
    for grp, files in d.get('file_groups', {}).items():
        mets.file_groups[grp] = [MetsFile(**f) for f in files]
    return mets


class MetsServer:
    """Serve one workspace's METS over a unix socket.

    Usage (in a dedicated process, like the reference's test fixture)::

        server = MetsServer(workspace, '/tmp/ws.sock')
        server.serve_forever()        # blocks; .shutdown() from a client

    or in-process for tests: ``server.start()`` / ``server.stop()``.
    """

    def __init__(self, workspace: Workspace, url: str):
        self.workspace = workspace
        self.url = url
        self.lock = threading.Lock()
        if os.path.exists(url):
            # a LIVE server must not be silently hijacked (two
            # 'authoritative' METS instances would alternately
            # overwrite mets.xml); only a stale SOCKET is removed —
            # anything else at the path (e.g. the user passed the
            # mets.xml itself as --url) must never be unlinked
            import stat
            if not stat.S_ISSOCK(os.stat(url).st_mode):
                raise OSError(
                    '%s exists and is not a socket (pass a socket '
                    'path as the METS server url)' % url)
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(url)
            except OSError:
                os.unlink(url)   # stale leftover
            else:
                probe.close()
                raise OSError(
                    'METS server already listening on %s' % url)
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline(_MAXLINE)
                    if not line:
                        return
                    if not line.endswith(b'\n'):
                        # oversized request: the stream is no longer
                        # line-aligned — close instead of desyncing
                        LOG.error('request exceeds %d bytes: closing '
                                  'connection', _MAXLINE)
                        return
                    try:
                        req = json.loads(line)
                        result = outer._dispatch(req.get('method'),
                                                 req.get('params') or {})
                        resp = {'ok': True, 'result': result}
                    except _Shutdown:
                        self.wfile.write(
                            json.dumps({'ok': True, 'result': None})
                            .encode() + b'\n')
                        self.wfile.flush()
                        threading.Thread(
                            target=outer.server.shutdown).start()
                        return
                    except Exception as err:  # noqa: BLE001 — protocol edge
                        if isinstance(err, FileExistsError):
                            # expected control flow (client-side
                            # OCRD_EXISTING_OUTPUT policy): no ERROR
                            # traceback per skipped page
                            LOG.info('mets server: %s', err)
                        else:
                            LOG.exception('mets server error')
                        resp = {'ok': False,
                                'error_type': type(err).__name__,
                                'error': '%s: %s'
                                % (type(err).__name__, err)}
                    self.wfile.write(json.dumps(resp).encode() + b'\n')
                    self.wfile.flush()

        class Server(socketserver.ThreadingMixIn,
                     socketserver.UnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        self.server = Server(url, Handler)
        self._thread: Optional[threading.Thread] = None

    # -- method dispatch (all mutations behind the lock) --------------

    def _dispatch(self, method: str, params: dict):
        if method == 'mets':
            with self.lock:
                return _mets_to_dict(self.workspace.mets)
        if method == 'directory':
            return self.workspace.directory
        if method == 'add_file':
            with self.lock:
                f = self.workspace.add_file(
                    params['file_grp'], params['ID'],
                    params.get('pageId'), params['local_filename'],
                    mimetype=params.get('mimetype') or 'application/'
                    'vnd.prima.page+xml',
                    content=params.get('content'),
                    force=bool(params.get('force')))
                return {'ID': f.ID, 'fileGrp': f.fileGrp,
                        'mimetype': f.mimetype,
                        'local_filename': f.local_filename,
                        'pageId': f.pageId}
        if method == 'save':
            with self.lock:
                self.workspace.save_mets()
                return None
        if method == 'stop':
            raise _Shutdown()
        raise ValueError('unknown method %r' % method)

    # -- lifecycle -----------------------------------------------------

    def serve_forever(self):
        LOG.info('METS server listening on %s (workspace %s)',
                 self.url, self.workspace.directory)
        try:
            self.server.serve_forever()
        finally:
            self.server.server_close()
            if os.path.exists(self.url):
                os.unlink(self.url)

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


class _Shutdown(Exception):
    pass


def serve(directory: str, url: str) -> None:
    """Serve the workspace in ``directory`` on the unix socket ``url``
    until a client sends ``stop`` (the body of a server process)."""
    MetsServer(Workspace(directory), url).serve_forever()


class _Client:
    """One persistent connection, one request in flight at a time."""

    # Startup race: the server's socket file appears at bind() time,
    # a moment before listen() — and a worker may start before the
    # server at all.  Retry refused/missing connections briefly so
    # clients that race the server's startup (fixture processes, CLI
    # `worker` roles pointed at a just-launched `mets-server`) succeed.
    CONNECT_TIMEOUT = 10.0

    def __init__(self, url: str):
        self.url = url
        self.lock = threading.Lock()
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + self.CONNECT_TIMEOUT
        while True:
            try:
                self.sock.connect(url)
                break
            except (ConnectionRefusedError, FileNotFoundError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self.rfile = self.sock.makefile('rb')

    def call(self, method: str, **params):
        req = json.dumps({'method': method, 'params': params})
        with self.lock:
            self.sock.sendall(req.encode() + b'\n')
            line = self.rfile.readline(_MAXLINE)
        if not line:
            raise ConnectionError('METS server closed the connection')
        if not line.endswith(b'\n'):
            self.close()
            raise ConnectionError(
                'METS server response exceeds %d bytes' % _MAXLINE)
        resp = json.loads(line)
        if not resp.get('ok'):
            msg = 'METS server: %s' % resp.get('error',
                                               'unknown error')
            # re-raise builtin exception TYPES across the protocol:
            # KerasRate's OCRD_EXISTING_OUTPUT policy catches
            # FileExistsError from add_file, which must keep working
            # when the workspace is remote
            import builtins
            cls = getattr(builtins, resp.get('error_type', ''), None)
            if isinstance(cls, type) and issubclass(cls, Exception):
                raise cls(msg)
            raise RuntimeError(msg)
        return resp.get('result')

    def close(self):
        try:
            self.rfile.close()
            self.sock.close()
        except OSError:
            pass


class RemoteWorkspace:
    """Workspace façade backed by a :class:`MetsServer`.

    Reads use a local snapshot (`refresh()` re-pulls); `add_file` and
    `save_mets` are forwarded, so concurrent page workers in separate
    threads/processes serialize their METS updates at the server.
    """

    def __init__(self, url: str):
        self.client = _Client(url)
        self.directory = self.client.call('directory')
        self.mets = _mets_from_dict(self.client.call('mets'))

    def refresh(self):
        self.mets = _mets_from_dict(self.client.call('mets'))

    def download_file(self, f: MetsFile) -> MetsFile:
        return f

    def add_file(self, file_grp: str, ID: str, pageId, local_filename,
                 mimetype: str = 'application/vnd.prima.page+xml',
                 content: Optional[str] = None,
                 force: bool = False) -> MetsFile:
        result = self.client.call(
            'add_file', file_grp=file_grp, ID=ID, pageId=pageId,
            local_filename=local_filename, mimetype=mimetype,
            content=content, force=force)
        f = MetsFile(**result)
        # mirror into the local snapshot so subsequent reads see it —
        # dropping a replaced ID from WHATEVER group held it (the
        # server moves cross-group force-replacements the same way;
        # searching only the target group left a stale duplicate)
        for files in self.mets.file_groups.values():
            for i, existing in enumerate(files):
                if existing.ID == f.ID:
                    del files[i]
                    break
        self.mets.file_groups.setdefault(file_grp, []).append(f)
        if f.pageId and f.pageId not in self.mets.page_ids:
            self.mets.page_ids.append(f.pageId)
        return f

    def save_mets(self):
        self.client.call('save')

    def stop_server(self):
        try:
            self.client.call('stop')
        except (ConnectionError, RuntimeError, OSError):
            pass

    def close(self):
        self.client.close()
