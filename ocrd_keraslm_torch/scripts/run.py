"""The ``keraslm-rate`` command group of the port.

Counterpart of ``ocrd_keraslm_tpu/scripts/run.py``: the same ten
commands and group options, run as::

    python -m ocrd_keraslm_torch.scripts.run apply -m MODEL.h5 "text"
    python -m ocrd_keraslm_torch.scripts.run test -m MODEL.h5 FILES...

``apply`` (per-character probabilities and base-2 perplexity) and
``test`` (corpus perplexity) run on CUDA, or on the CPU with
``KERASLM_PLATFORM=cpu``.  The other commands are registered and raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from math import ceil

import click

from ..rater import Rater


class SortedGroup(click.Group):
    """Keep commands in a task-logical order (train first)."""

    ORDER = ['train', 'test', 'apply', 'generate', 'print-history',
             'print-charset', 'prune-charset',
             'plot-char-embeddings-similarity',
             'plot-context-embeddings-similarity',
             'plot-context-embeddings-projection']

    def list_commands(self, ctx):
        commands = set(super().list_commands(ctx))
        return self.ORDER + sorted(commands.difference(self.ORDER))


@click.group(cls=SortedGroup)
@click.option('-l', '--log-level', default='INFO', show_default=True,
              type=click.Choice(['DEBUG', 'INFO', 'WARNING', 'ERROR'],
                                case_sensitive=False))
@click.option('--profile', is_flag=True,
              help='enable host profiling (cProfile)')
@click.option('--profile-file', default=None,
              type=click.Path(dir_okay=False, writable=True),
              help='write host profile stats to this file')
@click.option('--jax-trace', default=None,
              help='device trace directory (not ported yet)')
def cli(log_level, profile, profile_file, jax_trace):
    if jax_trace:
        raise NotImplementedError(
            '--jax-trace is not ported yet (ROADMAP.md Queue 1, '
            '"Device trace")')
    logging.basicConfig(
        level=getattr(logging, log_level.upper(), logging.INFO),
        format='%(asctime)s %(levelname)s %(name)s - %(message)s')
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
                pstats.Stats(prof).sort_stats('cumulative').print_stats(30)
        atexit.register(_dump)


def _expand_paths(items):
    out = []
    for item in items:
        if os.path.isdir(item):
            out.extend(sorted(
                os.path.join(item, f) for f in os.listdir(item)
                if os.path.isfile(os.path.join(item, f))))
        else:
            out.append(item)
    return out


def _parse_context(context):
    if not context:
        return None
    return [ceil(int(x) / 10) for x in context.split(' ')]


def _load_rater(model):
    rater = Rater()
    rater.load_config(model)
    rater.configure()
    rater.load_weights(model)
    return rater


@cli.command(short_help='get individual probabilities from language model')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.option('-c', '--context', default=None,
              help='constant meta-data input')
@click.argument('text', type=click.STRING)
def apply(model, text, context):
    """Rate TEXT with the model: per-character probabilities plus the
    overall perplexity.

    Pass '-' as TEXT to rate standard input instead.
    """
    rater = _load_rater(model)
    if text and text[0] == '-':
        text = sys.stdin.read()
    ratings, perplexity = rater.rate2(text, _parse_context(context))
    click.echo(perplexity)
    click.echo(json.dumps(ratings, ensure_ascii=False))


@cli.command(short_help='get overall perplexity from language model')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.argument('data', nargs=-1,
                type=click.Path(exists=True, dir_okay=True,
                                file_okay=True))
def test(model, data):
    """Evaluate the model on the DATA text files and print the corpus
    perplexity."""
    rater = _load_rater(model)
    click.echo(rater.test(_expand_paths(data)))


def _not_ported(name, item):
    @cli.command(name=name, context_settings=dict(
        ignore_unknown_options=True, allow_extra_args=True),
        short_help='not ported yet (ROADMAP.md Queue 1, "%s")' % item)
    def command():
        raise NotImplementedError(
            'keraslm-rate %s is not ported yet (ROADMAP.md Queue 1, "%s")'
            % (name, item))
    return command


for _name, _item in (
        ('train', 'Training'), ('generate', 'Generation'),
        ('print-history', '`keraslm-rate` CLI and tooling'),
        ('print-charset', '`keraslm-rate` CLI and tooling'),
        ('prune-charset', '`keraslm-rate` CLI and tooling'),
        ('plot-char-embeddings-similarity',
         '`keraslm-rate` CLI and tooling'),
        ('plot-context-embeddings-similarity',
         '`keraslm-rate` CLI and tooling'),
        ('plot-context-embeddings-projection',
         '`keraslm-rate` CLI and tooling')):
    _not_ported(_name, _item)


if __name__ == '__main__':
    cli()
