"""CLI for the ``ocrd-keraslm-rate`` processor of the PyTorch port.

Counterpart of the standalone processor command of
``ocrd_keraslm_tpu/wrapper/cli.py``: the standard OCR-D processor
options (-m/-I/-O/-p/-P/--overwrite) over a local workspace::

    python -m ocrd_keraslm_torch.wrapper.cli -m WS/mets.xml \\
        -I OCR-D-OCR -O OCR-D-LM -P model_file pretrained/model_german.h5

It decodes the lattice of alternatives (with ``-P device_decoding
false`` by the host decode engine, one device step per char position),
or with ``-P alternative_decoding false`` scores the text, on CUDA;
``KERASLM_PLATFORM=cpu`` selects the CPU.
"""
from __future__ import annotations

import json
import logging
import os

import click

from .mets import Workspace
from .rate import OCRD_TOOL, KerasRate


def _setup_runtime(log_level, profile, profile_file):
    logging.basicConfig(level=getattr(logging, log_level.upper(),
                                      logging.INFO))
    if profile or profile_file:
        import atexit
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
        atexit.register(_dump)


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


def _open_workspace(mets):
    directory = mets if os.path.isdir(mets) else os.path.dirname(mets) \
        or '.'
    return Workspace(directory)


@click.command()
@click.option('-m', '--mets', default='mets.xml', show_default=True,
              help='METS file or workspace directory')
@click.option('-I', '--input-file-grp', default='OCR-D-OCR',
              show_default=True)
@click.option('-O', '--output-file-grp', default='OCR-D-LM',
              show_default=True)
@click.option('-p', '--parameter', default=None,
              help='JSON file or string of processor parameters')
@click.option('-P', '--parameter-override', nargs=2, multiple=True,
              help='single parameter override (repeatable)')
@click.option('-U', '--mets-server-url', default=None,
              help='METS server socket (not ported yet)')
@click.option('--overwrite', is_flag=True,
              help='overwrite existing output files')
@click.option('-J', '--dump-json', is_flag=True,
              help='print tool description and exit')
@click.option('-l', '--log-level', default='INFO', show_default=True)
@click.option('--profile', is_flag=True,
              help='enable host profiling (cProfile)')
@click.option('--profile-file', default=None,
              type=click.Path(dir_okay=False, writable=True),
              help='write host profile stats to this file')
@click.option('--jax-trace', default=None,
              help='device trace directory (not ported yet)')
def ocrd_keraslm_rate(mets, input_file_grp, output_file_grp, parameter,
                      parameter_override, mets_server_url, overwrite,
                      dump_json, log_level, profile, profile_file,
                      jax_trace):
    """Rate elements of the text with a character-level LSTM language
    model (PyTorch/CUDA)."""
    if mets_server_url:
        raise NotImplementedError(
            '--mets-server-url is not ported yet (ROADMAP.md Queue 1, '
            '"Serving roles")')
    if jax_trace:
        raise NotImplementedError(
            '--jax-trace is not ported yet (ROADMAP.md Queue 1, '
            '"Device trace")')
    _setup_runtime(log_level, profile, profile_file)
    if dump_json:
        click.echo(json.dumps(OCRD_TOOL, indent=2))
        return
    params = _parse_params(parameter, parameter_override)
    if overwrite:
        os.environ['OCRD_EXISTING_OUTPUT'] = 'OVERWRITE'
    workspace = _open_workspace(mets)
    processor = KerasRate(workspace=workspace,
                          input_file_grp=input_file_grp,
                          output_file_grp=output_file_grp,
                          parameter=params)
    processor.setup()
    processor.process_workspace(workspace)


def main():
    """Console entry point (standalone processor)."""
    return ocrd_keraslm_rate()


if __name__ == '__main__':
    main()
