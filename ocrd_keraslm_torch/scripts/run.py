"""The ``keraslm-rate`` command group of the port.

Counterpart of ``ocrd_keraslm_tpu/scripts/run.py``: the same ten
commands and group options, run as::

    python -m ocrd_keraslm_torch.scripts.run apply -m MODEL.h5 "text"
    python -m ocrd_keraslm_torch.scripts.run test -m MODEL.h5 FILES...

    python -m ocrd_keraslm_torch.scripts.run train -m MODEL.h5 FILES...
    python -m ocrd_keraslm_torch.scripts.run generate -m MODEL.h5 \
        -n 1000 -v 3 "Die Vernunft "

    python -m ocrd_keraslm_torch.scripts.run train --resume-dir SNAP ...
    python -m ocrd_keraslm_torch.scripts.run prune-charset -m MODEL.h5 "#"
    python -m ocrd_keraslm_torch.scripts.run --jax-trace DIR test ...

``train`` (with continuation from a model or checkpoint, and with
``--resume-dir`` full train-state snapshots at every epoch, from which
a killed run resumes), ``apply`` (per-character probabilities and
base-2 perplexity), ``test`` (corpus perplexity), ``generate``
(beam-search continuations of a prefix), ``print-history``,
``print-charset``, ``prune-charset`` (delete a char and its embedding
row) and the three embedding plots (matplotlib and scikit-learn, the
``plotting`` extra, imported by the plot) run on CUDA, or on the CPU
with ``KERASLM_PLATFORM=cpu``.  ``--jax-trace DIR`` writes a
``torch.profiler`` trace of the command into DIR.

``train --mesh DP`` (data parallel), ``DPxMP`` (and the vocabulary
over MP ranks) or ``DPxPPp`` (PP pipeline stages) shards the training
over a mesh of that many ranks, one process each, every rank running
the same command::

    torchrun --standalone --nproc-per-node 4 \
        -m ocrd_keraslm_torch.scripts.run train --mesh 2x2 ...

or with ``KERASLM_COORDINATOR=host:port``, ``KERASLM_NUM_PROCESSES``
and ``KERASLM_PROCESS_ID`` set for each rank (the JAX package's
multihost variables).  The group is joined when the command starts;
rank 0 writes the model.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from functools import partial
from math import ceil

import click

from ..parallel.mesh import make_mesh
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
              type=click.Path(file_okay=False, writable=True),
              help='capture a device trace (torch.profiler, Chrome trace '
                   'JSON) of the command into this directory')
@click.pass_context
def cli(ctx, log_level, profile, profile_file, jax_trace):
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
    if jax_trace:
        # written when the command ends
        from ..utils.devtrace import start_trace
        ctx.call_on_close(start_trace(jax_trace))
    # several ranks: join the group before any device work (a partial
    # KERASLM_* configuration is refused here, not trained per process)
    from ..parallel import multihost
    try:
        multihost.join_from_env()
    except ValueError as err:  # partial KERASLM_* configuration
        raise click.UsageError(str(err))
    except RuntimeError as err:  # no cluster environment
        raise click.UsageError(
            'multihost initialization failed: %s (KERASLM_MULTIHOST=1 '
            'relies on the torchrun variables; set KERASLM_COORDINATOR/'
            'KERASLM_NUM_PROCESSES/KERASLM_PROCESS_ID explicitly '
            'otherwise)' % err)


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


def _load_rater(model, incremental=False):
    rater = Rater()
    rater.load_config(model)
    if incremental:
        rater.stateful = False
        rater.incremental = True
    rater.configure()
    rater.load_weights(model)
    return rater


@cli.command(short_help='train a language model')
@click.option('-m', '--model', default='model.h5', show_default=True,
              help='model file', type=click.Path(dir_okay=False,
                                                 writable=True))
@click.option('-C', '--ckpt', default='ckpt.h5', show_default=True,
              help='checkpoint file', type=click.Path(dir_okay=False))
@click.option('-w', '--width', default=128, show_default=True,
              help='number of nodes per hidden layer',
              type=click.IntRange(min=1, max=9128))
@click.option('-d', '--depth', default=2, show_default=True,
              help='number of hidden layers',
              type=click.IntRange(min=1, max=10))
@click.option('-l', '--length', default=256, show_default=True,
              help='number of previous characters seen (window size)',
              type=click.IntRange(min=1, max=1024))
@click.option('-v', '--val-data', default=None, show_default=True,
              help='validation data file or directory '
                   '(instead of automatic split)',
              type=click.Path(exists=True, dir_okay=True, file_okay=True))
@click.option('-e', '--epochs', default=100, show_default=True,
              help='maximum number of epochs (early-stopped)',
              type=click.IntRange(min=1, max=10000))
@click.option('-b', '--batch-size', default=128, show_default=True,
              help='parallel training streams',
              type=click.IntRange(min=1, max=65536))
@click.option('--bf16', is_flag=True,
              help='bfloat16 matmul operands in the recurrent core '
                   '(float32 cell state/softmax)')
@click.option('--resume-dir', default=None,
              type=click.Path(file_okay=False),
              help='directory for full train-state snapshots (params, '
                   'Adam moments, dropout generator, history): every '
                   'epoch is snapshotted and an interrupted run resumes '
                   'from the last completed epoch')
@click.option('--widths', default=None, metavar='W1,W2,...',
              help='each layer\'s width (AWD-LSTM enwik8: 1840,1840,400); '
                   'sets the depth, and the last width is the char '
                   'embedding\'s (the softmax is tied)')
@click.option('--head-bias', is_flag=True,
              help='a bias on the tied softmax\'s logits')
@click.option('--weight-drop', default=0.0, show_default=True,
              type=click.FloatRange(0.0, 1.0, max_open=True),
              help='DropConnect rate on each layer\'s recurrent matrix')
@click.option('--dropout-input', default=0.0, show_default=True,
              type=click.FloatRange(0.0, 1.0, max_open=True),
              help='locked dropout on the embedded input (any of the three '
                   '--dropout-* options replaces the default dropout '
                   'between layers)')
@click.option('--dropout-hidden', default=0.0, show_default=True,
              type=click.FloatRange(0.0, 1.0, max_open=True),
              help='locked dropout on the output of every layer below the '
                   'last')
@click.option('--dropout-output', default=0.0, show_default=True,
              type=click.FloatRange(0.0, 1.0, max_open=True),
              help='locked dropout on the last layer\'s output')
@click.option('--no-contexts', is_flag=True,
              help='no context input (the year-decade embedding)')
@click.option('--mesh', 'mesh_spec', default=None, metavar='DPxMP',
              help='shard the train step over a mesh of ranks, e.g. "4" '
                   '(4-way data parallel), "4x2" (4-way data x 2-way '
                   'model parallel), or "2x4p" (2-way data x 4-stage '
                   'GPipe pipeline over the layer stack; depth must '
                   'divide by the stage count); needs that many ranks '
                   '(torchrun, or the KERASLM_* variables) and a '
                   'batch_size divisible by DP')
@click.argument('data', nargs=-1,
                type=click.Path(exists=True, dir_okay=True,
                                file_okay=True))
def train(model, ckpt, width, depth, length, val_data, epochs,
          batch_size, bf16, widths, head_bias, weight_drop,
          dropout_input, dropout_hidden, dropout_output, no_contexts,
          resume_dir, mesh_spec, data):
    """Fit a char-LM of the given WIDTH/DEPTH/LENGTH on the DATA
    text files.

    Without VAL_DATA, a random train/validation split is made.
    """
    from .. import training
    training.EPOCHS = epochs
    layer_widths = ()
    if widths:
        try:
            layer_widths = tuple(int(w) for w in widths.split(','))
        except ValueError:
            raise click.UsageError('--widths expects widths separated by '
                                   'commas, e.g. 1840,1840,400')
        depth, width = len(layer_widths), layer_widths[-1]

    rater = Rater()
    continuation = None
    if os.path.isfile(model):
        rater.load_config(model)
        if rater.width == width and rater.depth == depth and \
                tuple(rater.widths) == layer_widths:
            continuation = partial(rater.load_weights, model)
            print('continuing training from saved model %s' % model)
        else:
            rater.status = 0
            print('warning: saved model %s has different topology '
                  '(width=%d, depth=%d) - starting fresh'
                  % (model, rater.width, rater.depth), file=sys.stderr)
    elif os.path.isfile(ckpt):
        continuation = partial(rater.load_weights, ckpt)
        print('continuing training from checkpoint %s' % ckpt)
    rater.width = width
    rater.depth = depth
    rater.widths = layer_widths
    rater.head_bias = head_bias
    rater.weight_drop = weight_drop
    rater.dropout_input = dropout_input
    rater.dropout_hidden = dropout_hidden
    rater.dropout_output = dropout_output
    if no_contexts:
        rater.contexts = ()
    rater.length = length
    rater.batch_size = batch_size
    if resume_dir:
        rater.resume_dir = resume_dir
    if bf16:
        rater.compute_dtype = 'bfloat16'
    if mesh_spec:
        rater.mesh = _train_mesh(mesh_spec)
    try:
        rater.configure()
    except ValueError as err:  # widths the tied softmax refuses
        raise click.UsageError(str(err))
    if continuation:
        continuation()
    val_files = _expand_paths([val_data]) if val_data else None
    rater.train(_expand_paths(data), val_data=val_files)
    if rater.status != 2:
        raise click.ClickException('training failed: no model saved')
    # every rank calls save: rank 0 alone writes the (shared) path
    rater.save(model)


def _train_mesh(mesh_spec):
    """The mesh of ``--mesh DP``, ``DPxMP`` or ``DPxPPp`` over the ranks
    of the world, with the JAX package's refusals."""
    from ..parallel import multihost
    from ..parallel.pipeline import make_pipe_mesh
    try:
        parts = mesh_spec.lower().split('x')
        pipe = parts[-1].endswith('p')
        if pipe:
            pp = int(parts[-1][:-1])
            dp = int(parts[0]) if len(parts) > 1 else 1
            n = dp * pp
        else:
            dp = int(parts[0])
            mp = int(parts[1]) if len(parts) > 1 else 1
            n = dp * mp
    except ValueError:
        raise click.UsageError(
            '--mesh expects DP, DPxMP or DPxPPp (e.g. "4", "4x2", '
            '"2x4p"), got %r' % mesh_spec)
    world = multihost.world_size()
    if n != world:
        raise click.UsageError(
            '--mesh %s has %d ranks but the world has %d processes: '
            'launch %d (torchrun --nproc-per-node %d, or the KERASLM_* '
            'variables)' % (mesh_spec, n, world, n, n))
    try:
        if pipe:
            if multihost.is_multihost():
                raise click.UsageError(
                    'pipeline meshes (--mesh %s) are single-host; unset '
                    'KERASLM_COORDINATOR/KERASLM_NUM_PROCESSES or use a '
                    'DPxMP mesh (multi-host dp/tp)' % mesh_spec)
            return make_pipe_mesh(n, pipe_parallel=pp)
        if multihost.is_multihost():
            return multihost.make_global_mesh(model_parallel=mp)
        return make_mesh(n, model_parallel=mp)
    except ValueError as err:
        raise click.UsageError(str(err))


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


@cli.command(short_help='sample characters from language model')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.option('-n', '--number', default=1,
              help='number of characters to sample',
              type=click.IntRange(min=1, max=10000))
@click.option('-v', '--variants', default=1,
              help='number of character sequences to sample',
              type=click.IntRange(min=1, max=10000))
@click.option('-c', '--context', default=None,
              help='constant meta-data input')
@click.argument('prefix', type=click.STRING)
def generate(model, number, variants, context, prefix):
    """Sample the most probable continuations of PREFIX from the
    model (beam search)."""
    rater = _load_rater(model, incremental=True)
    context = _parse_context(context) or rater.underspecify_contexts()
    for res in rater.generate(prefix, number, context, variants):
        click.echo(prefix[:-1] + res)


@cli.command(short_help='Print the training history')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
def print_history(model):
    rater = Rater()
    rater.load_config(model)
    rater.print_history()


@cli.command(short_help='Print the mapped characters')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
def print_charset(model):
    rater = Rater()
    rater.load_config(model)
    rater.print_charset()


@cli.command(short_help='Delete one character from mapping')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True,
                              writable=True))
@click.argument('char')
def prune_charset(model, char):
    """Delete CHAR from the model's mapping and its row from the
    embedding, and save the model in place."""
    rater = _load_rater(model)
    if rater.remove_from_mapping(char=char):
        rater.save(model)


@cli.command(short_help='Paint a heat map of character embeddings')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.argument('filename', type=click.Path(dir_okay=False,
                                            writable=True))
def plot_char_embeddings_similarity(model, filename):
    _load_rater(model).plot_char_embeddings_similarity(filename)


@cli.command(short_help='Paint a heat map of context embeddings')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.option('-n', '--number', default=1,
              help='which context variable',
              type=click.IntRange(min=1, max=100))
@click.argument('filename', type=click.Path(dir_okay=False,
                                            writable=True))
def plot_context_embeddings_similarity(model, filename, number):
    _load_rater(model).plot_context_embeddings_similarity(filename,
                                                          n=number)


@cli.command(short_help='Paint a 2-d PCA projection of context embeddings')
@click.option('-m', '--model', required=True, help='model file',
              type=click.Path(dir_okay=False, exists=True))
@click.option('-n', '--number', default=1,
              help='which context variable',
              type=click.IntRange(min=1, max=100))
@click.argument('filename', type=click.Path(dir_okay=False,
                                            writable=True))
def plot_context_embeddings_projection(model, filename, number):
    _load_rater(model).plot_context_embeddings_projection(filename,
                                                          n=number)


if __name__ == '__main__':
    cli()
