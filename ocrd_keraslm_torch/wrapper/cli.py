"""CLI for the ``ocrd-keraslm-rate`` processor of the PyTorch port.

Counterpart of ``ocrd_keraslm_tpu/wrapper/cli.py``: a click group with
the standard OCR-D processor options (-m/-I/-O/-p/-P/--overwrite,
--mets-server-url) and the network service roles that OCR-D core adds
to a processor, implemented standalone:

* ``ocrd-keraslm-rate`` (no subcommand): process one workspace::

      python -m ocrd_keraslm_torch.wrapper.cli -m WS/mets.xml \\
          -I OCR-D-OCR -O OCR-D-LM -P model_file pretrained/model_german.h5

  It decodes the lattice of alternatives (with ``-P device_decoding
  false`` by the host decode engine), or with ``-P alternative_decoding
  false`` scores the text; ``-U SOCKET`` reads and writes the METS
  through a METS server instead of ``mets.xml``;
* ``ocrd-keraslm-rate server HOST:PORT``: a long-lived HTTP processing
  server; the model loads once, then each ``POST /process`` job runs on
  the warm rater (``GET /`` or ``/info``: the ocrd-tool JSON, ``GET
  /health``: 200 once the model is ready);
* ``ocrd-keraslm-rate worker --queue DIR``: a spool-directory job
  worker: it claims ``*.json`` job files (the ``POST /process`` payload)
  by renaming them, processes them on its warm rater, renames each to
  ``<job>.done`` and writes ``<job>.result.json``;
* ``ocrd-keraslm-rate mets-server --mets DIR SOCKET``: serves one
  workspace's METS on a unix socket for page-parallel runs in several
  processes.

Every role runs on CUDA; ``KERASLM_PLATFORM=cpu`` selects the CPU.
``--jax-trace DIR`` writes a ``torch.profiler`` trace of the run into
DIR (``utils/devtrace.py``).
"""
from __future__ import annotations

import json
import logging
import os
import sys

import click

from .mets import Workspace
from .rate import OCRD_TOOL, KerasRate

PROCESS_OPTIONS = [
    click.option('-m', '--mets', default='mets.xml', show_default=True,
                 help='METS file or workspace directory'),
    click.option('-I', '--input-file-grp', default='OCR-D-OCR',
                 show_default=True),
    click.option('-O', '--output-file-grp', default='OCR-D-LM',
                 show_default=True),
    click.option('-p', '--parameter', default=None,
                 help='JSON file or string of processor parameters'),
    click.option('-P', '--parameter-override', nargs=2, multiple=True,
                 help='single parameter override (repeatable)'),
    click.option('-U', '--mets-server-url', default=None,
                 help='connect to a METS server at this unix socket '
                      'path instead of reading mets.xml directly'),
    click.option('--overwrite', is_flag=True,
                 help='overwrite existing output files'),
    click.option('-J', '--dump-json', is_flag=True,
                 help='print tool description and exit'),
    click.option('-l', '--log-level', default='INFO',
                 show_default=True),
    click.option('--profile', is_flag=True,
                 help='enable host profiling (cProfile)'),
    click.option('--profile-file', default=None,
                 type=click.Path(dir_okay=False, writable=True),
                 help='write host profile stats to this file'),
    click.option('--jax-trace', default=None,
                 type=click.Path(file_okay=False, writable=True),
                 help='capture a device trace (torch.profiler, Chrome '
                      'trace JSON) into this directory'),
]


def _setup_runtime(log_level, profile, profile_file, jax_trace, ctx=None):
    """Logging, and the host profile and device trace, each written
    when the command ends (``ctx`` closes, or the process exits)."""
    logging.basicConfig(level=getattr(logging, log_level.upper(),
                                      logging.INFO))
    import atexit
    on_close = ctx.call_on_close if ctx is not None else atexit.register
    if profile or profile_file:
        import cProfile
        import pstats
        prof = cProfile.Profile()
        prof.enable()

        def _dump():
            prof.disable()
            if profile_file:
                prof.dump_stats(profile_file)
            else:
                pstats.Stats(prof).sort_stats('cumulative') \
                    .print_stats(30)
        on_close(_dump)
    if jax_trace:
        from ..utils.devtrace import start_trace
        on_close(start_trace(jax_trace))


def _parse_params(parameter, parameter_override):
    params = {}
    if parameter:
        if os.path.isfile(parameter):
            with open(parameter, encoding='utf-8') as fh:
                params = json.load(fh)
        else:
            params = json.loads(parameter)
    for key, value in parameter_override or ():
        schema = OCRD_TOOL['parameters'].get(key, {})
        if schema.get('type') == 'boolean':
            value = value.lower() in ('1', 'true', 'yes')
        elif schema.get('type') == 'number':
            # ints stay ints (beam_width); anything else (decimals,
            # scientific notation like 1e-1) parses as float
            try:
                value = int(value)
            except ValueError:
                value = float(value)
        params[key] = value
    return params


def _open_workspace(mets, mets_server_url):
    if mets_server_url:
        from .mets_server import RemoteWorkspace
        return RemoteWorkspace(mets_server_url)
    directory = mets if os.path.isdir(mets) else os.path.dirname(mets) \
        or '.'
    return Workspace(directory)


def _run_processor(workspace, input_file_grp, output_file_grp, params,
                   rater=None):
    processor = KerasRate(workspace=workspace,
                          input_file_grp=input_file_grp,
                          output_file_grp=output_file_grp,
                          parameter=params)
    if rater is not None:
        processor.rater = rater
    else:
        processor.setup()
    processor.process_workspace(workspace)
    return processor


@click.group(invoke_without_command=True)
@click.pass_context
def ocrd_keraslm_rate(ctx, **kwargs):
    """Rate elements of the text with a character-level LSTM language
    model (PyTorch/CUDA)."""
    if ctx.invoked_subcommand is not None:
        return
    _setup_runtime(kwargs['log_level'], kwargs['profile'],
                   kwargs['profile_file'], kwargs['jax_trace'], ctx)
    if kwargs['dump_json']:
        click.echo(json.dumps(OCRD_TOOL, indent=2))
        return
    params = _parse_params(kwargs['parameter'],
                           kwargs['parameter_override'])
    if kwargs['overwrite']:
        os.environ['OCRD_EXISTING_OUTPUT'] = 'OVERWRITE'
    workspace = _open_workspace(kwargs['mets'], kwargs['mets_server_url'])
    _run_processor(workspace, kwargs['input_file_grp'],
                   kwargs['output_file_grp'], params)


for _opt in reversed(PROCESS_OPTIONS):
    ocrd_keraslm_rate = _opt(ocrd_keraslm_rate)


def main():
    """Console entry point: the genuine OCR-D core's CLI where that core
    is installed (``KERASLM_STANDALONE=1`` forces the standalone one),
    the standalone group otherwise.  The service subcommands (worker,
    server, mets-server) have no genuine counterpart here: they always
    take the standalone group."""
    from .ocrd_adapter import genuine_ocrd_available
    if len(sys.argv) > 1 and sys.argv[1] in ocrd_keraslm_rate.commands:
        return ocrd_keraslm_rate()
    if genuine_ocrd_available():
        from ocrd.decorators import (ocrd_cli_options,
                                     ocrd_cli_wrap_processor)

        from .ocrd_adapter import make_processor_class

        @click.command()
        @ocrd_cli_options
        def genuine_cli(*args, **kwargs):
            return ocrd_cli_wrap_processor(make_processor_class(),
                                           *args, **kwargs)
        return genuine_cli()
    return ocrd_keraslm_rate()


@ocrd_keraslm_rate.command('mets-server')
@click.option('-m', '--mets', default='.', show_default=True,
              help='METS file or workspace directory to serve')
@click.option('-l', '--log-level', default='INFO', show_default=True)
@click.argument('url')
def mets_server_cmd(mets, log_level, url):
    """Serve one workspace's METS on the unix socket URL (page-parallel
    runs in several processes connect with --mets-server-url URL)."""
    logging.basicConfig(level=getattr(logging, log_level.upper(),
                                      logging.INFO))
    from .mets_server import MetsServer
    directory = mets if os.path.isdir(mets) else os.path.dirname(mets) \
        or '.'
    MetsServer(Workspace(directory), url).serve_forever()


@ocrd_keraslm_rate.command('server')
@click.argument('address', default='127.0.0.1:8080')
@click.option('-p', '--parameter', default=None,
              help='JSON file or string of processor parameters '
                   '(the model loads once at startup)')
@click.option('-P', '--parameter-override', nargs=2, multiple=True)
@click.option('-l', '--log-level', default='INFO', show_default=True)
def server_cmd(address, parameter, parameter_override, log_level):
    """Long-lived HTTP processing server on ADDRESS (host:port).

    The model loads once; each POST /process {"mets": ...,
    "input_file_grp": ..., "output_file_grp": ..., "parameter": {...}}
    then runs on the warm rater.  GET / (or /info) returns the
    ocrd-tool description; GET /health returns 200 once the model is
    ready.
    """
    _setup_runtime(log_level, False, None, None)
    params0 = _parse_params(parameter, parameter_override)
    httpd = make_processing_server(address, params0)
    log = logging.getLogger('ocrd_keraslm_torch.server')
    log.info('processing server listening on %s', address)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def _filled(params, key):
    """A parameter's value with the tool's default filled in."""
    if key in params:
        return params[key]
    return OCRD_TOOL['parameters'][key].get('default')


def _run_job(job: dict, params0: dict, seed):
    """Run one serving job against the warm ``seed`` processor.

    Shared by the HTTP processing server and the spool worker, so both
    keep the same warm-rater reuse gate: a job reuses the loaded model
    only when it changes neither the model file nor the decode mode
    (both decide ``setup()``); explicitly passed defaults count as
    unchanged."""
    params = dict(params0)
    params.update(job.get('parameter') or {})
    workspace = _open_workspace(job.get('mets', 'mets.xml'),
                                job.get('mets_server_url'))
    rater = seed.rater if all(
        _filled(params, key) == _filled(params0, key)
        for key in ('model_file', 'alternative_decoding')) else None
    _run_processor(workspace,
                   job.get('input_file_grp', 'OCR-D-OCR'),
                   job.get('output_file_grp', 'OCR-D-LM'),
                   params, rater=rater)


def make_processing_server(address: str, params0: dict):
    """Build (but do not run) the processing HTTP server: loads the
    model once and returns a ``ThreadingHTTPServer`` whose /process jobs
    run on the warm rater, one at a time.  A job that fails answers 500
    with state FAILED."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seed = KerasRate(parameter=params0)
    seed.setup()   # load the model once
    log = logging.getLogger('ocrd_keraslm_torch.server')
    host, _, port = address.rpartition(':')
    # jobs share one warm rater, whose caches are not thread-safe:
    # serialise them; /health and /info still answer concurrently
    job_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ('/', '/info'):
                self._send(200, OCRD_TOOL)
            elif self.path == '/health':
                self._send(200, {'status': 'ok'})
            else:
                self._send(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/process':
                self._send(404, {'error': 'not found'})
                return
            try:
                n = int(self.headers.get('Content-Length', '0'))
                job = json.loads(self.rfile.read(n) or b'{}')
                with job_lock:
                    _run_job(job, params0, seed)
                self._send(200, {'state': 'SUCCESS'})
            except Exception as err:  # noqa: BLE001 - reported to the client
                log.exception('job failed')
                self._send(500, {'state': 'FAILED', 'error': str(err)})

        def log_message(self, fmt, *args):
            log.info(fmt, *args)

    return ThreadingHTTPServer((host or '127.0.0.1', int(port)), Handler)


@ocrd_keraslm_rate.command('worker')
@click.option('-q', '--queue', required=True,
              type=click.Path(file_okay=False),
              help='spool directory to poll for *.json job files')
@click.option('--poll-interval', default=0.5, show_default=True)
@click.option('--once', is_flag=True,
              help='process the jobs present now, then exit')
@click.option('-p', '--parameter', default=None)
@click.option('-P', '--parameter-override', nargs=2, multiple=True)
@click.option('-l', '--log-level', default='INFO', show_default=True)
def worker_cmd(queue, poll_interval, once, parameter,
               parameter_override, log_level):
    """Queue worker: poll QUEUE for job files and process them.

    Each job is a JSON file {"mets": ..., "input_file_grp": ...,
    "output_file_grp": ..., "parameter": {...}}; the worker claims it
    by renaming it (several workers may share a queue), processes it,
    renames it to ``<name>.done`` and writes ``<name>.result.json`` with
    {"state": "SUCCESS"|"FAILED", ...}.  The model loads once; all jobs
    share the warm rater.
    """
    import time
    _setup_runtime(log_level, False, None, None)
    log = logging.getLogger('ocrd_keraslm_torch.worker')
    params0 = _parse_params(parameter, parameter_override)
    seed = KerasRate(parameter=params0)
    seed.setup()
    os.makedirs(queue, exist_ok=True)
    log.info('worker polling %s', queue)
    while True:
        jobs = sorted(f for f in os.listdir(queue)
                      if f.endswith('.json')
                      and not f.endswith('.result.json'))
        if not jobs:
            if once:
                return
            time.sleep(poll_interval)
            continue
        for name in jobs:
            path = os.path.join(queue, name)
            claimed = path + '.claimed'
            try:
                os.rename(path, claimed)  # atomic claim
            except OSError:
                continue  # another worker took it
            result = {'state': 'SUCCESS'}
            try:
                with open(claimed, encoding='utf-8') as fh:
                    job = json.load(fh)
                _run_job(job, params0, seed)
            except Exception as err:  # noqa: BLE001 - one job's failure
                log.exception('job %s failed', name)
                result = {'state': 'FAILED', 'error': str(err)}
            os.rename(claimed, path + '.done')
            with open(os.path.join(queue, name[:-5] + '.result.json'), 'w',
                      encoding='utf-8') as fh:
                json.dump(result, fh)
            log.info('job %s: %s', name, result['state'])


if __name__ == '__main__':
    main()
