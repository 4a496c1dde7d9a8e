"""HDF5 checkpoint I/O, bit-compatible with the reference format.

Counterpart of ``ocrd_keraslm_tpu/utils/h5io.py``.  Two things live in
one ``.h5`` file:

1. **weights** in the Keras 2.3 ``save_weights`` HDF5 layout:
   top-level attr ``layer_names``; per-layer group with attr
   ``weight_names`` and datasets at those names.  Relevant layers:
   ``char_embedding`` (``embeddings:0`` (V, W)),
   ``context<i>_embedding``, and ``lstm_<i>``
   (``kernel:0`` (in, 4W), ``recurrent_kernel:0`` (W, 4W),
   ``bias:0`` (4W,)) with gate order i, f, c, o.
   CuDNNLSTM-trained files carry a doubled bias (8W,) — the two halves
   are summed on load (the same conversion Keras applies).

2. **config** group with datasets
   ``config/{history,width,depth,length,stateful,variable_length,mapping}``
   where ``mapping`` is a positional uint32 codepoint array (0 = gap).

A model of AWD-LSTM's keys (``models/lstm_lm.LMConfig``) adds, where
they differ from the defaults, ``config/{widths,head_bias,weight_drop,dropout_input,dropout_hidden,dropout_output}``,
and its head bias as ``char_output/bias:0`` (V,); a Keras LSTM layer
carries its own units, so the weights' layout does not change.

The file is read and written by the port's own HDF5 code
(``utils/hdf5.py``), so neither needs h5py, and files go both ways
between the two packages.  Weights load as numpy arrays;
``models.lstm_lm.params_from_numpy`` carries them onto a device, and
``save_weights`` takes tensors (on any device) or numpy arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.lstm_lm import LMConfig, Params, params_to_numpy
from . import hdf5
from .vocab import Vocab


class NumpyJSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

# LMConfig's keys beyond the reference schema, written where they differ
# from their defaults (so a model of the reference's shape writes the
# reference's group)
_AWD_KEYS = ('widths', 'head_bias', 'weight_drop',
             'dropout_input', 'dropout_hidden', 'dropout_output')


def _config_group(cfg: LMConfig, vocab: Vocab,
                  history: Optional[Dict[str, Any]]) -> dict:
    """The reference-schema ``config/`` group (``contexts`` and
    :data:`_AWD_KEYS` are this tool's extensions, which the reference
    ignores)."""
    extra = {}
    for key in _AWD_KEYS:
        value = getattr(cfg, key)
        if value != getattr(LMConfig, key):
            extra[key] = np.array(value, dtype=np.int64) if key == 'widths' \
                else np.array(value)
    return {'items': dict(extra, **{
        'history': json.dumps(history or {}, cls=NumpyJSONEncoder),
        'width': np.array(cfg.width),
        'depth': np.array(cfg.depth),
        'length': np.array(cfg.length),
        'stateful': np.array(bool(cfg.stateful)),
        'variable_length': np.array(bool(cfg.variable_length)),
        'mapping': vocab.to_codepoints(),
        'contexts': np.array(cfg.contexts, dtype=np.int64).reshape(-1, 2),
    })}


def _weights_tree(params: Params, cfg: LMConfig) -> dict:
    """The Keras 2.3 ``save_weights`` layout: every layer of the
    reference model a group (weightless ones empty), a weight at
    ``<layer>/<layer>/<name>:0``."""
    if torch.is_tensor(params['char_embedding']):
        params = params_to_numpy(params)
    n_ctx = cfg.n_contexts
    layer_names = ['char_input']
    layer_names += ['context%d_input' % (i + 1) for i in range(n_ctx)]
    layer_names.append('char_embedding')
    layer_names += ['context%d_embedding' % (i + 1) for i in range(n_ctx)]
    layer_names.append('concat_hidden_input')
    for i in range(cfg.depth):
        layer_names.append('lstm_%d' % (i + 1))
        if i > 0:
            layer_names.append('dropout_%d' % i)
    layer_names.append('char_output')
    weights = {'char_embedding': {
        'embeddings:0': params['char_embedding']}}
    for i, emb in enumerate(params['context_embeddings']):
        weights['context%d_embedding' % (i + 1)] = {'embeddings:0': emb}
    for i, lp in enumerate(params['lstm']):
        weights['lstm_%d' % (i + 1)] = {
            'kernel:0': lp['kernel'],
            'recurrent_kernel:0': lp['recurrent'], 'bias:0': lp['bias']}
    if 'head_bias' in params:
        weights['char_output'] = {'bias:0': params['head_bias']}
    items = {}
    for name in layer_names:
        own = weights.get(name, {})
        items[name] = {
            'attrs': {'weight_names': ['%s/%s' % (name, w) for w in own]},
            'items': {name: {'items': {
                w: np.asarray(a, np.float32) for w, a in own.items()}}}
            if own else {}}
    return {'attrs': {'layer_names': layer_names, 'backend': b'pytorch',
                      'keras_version': b'2.3.1'},
            'items': items}


def _is_writer() -> bool:
    """One writer per shared path in a job of several ranks (every rank
    runs the same command with the same paths): rank 0, or a process in
    no group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_params(params: Params, mesh=None) -> Params:
    """The canonical tree as numpy arrays on the host.  With ``mesh``,
    ``params`` are a rank's shard (``parallel.mesh.shard_params``) and
    the embedding rows are gathered over the mesh's ``model`` axis: a
    COLLECTIVE that every rank must enter, so :func:`save_weights` and
    :func:`save_model` run it on every rank and write on rank 0 only;
    call them from every rank, never from behind a rank test."""
    if mesh is not None:
        from ..parallel.mesh import gather_params as gather
        params = gather(mesh, params)
    if torch.is_tensor(params['char_embedding']):
        params = params_to_numpy(params)
    return params


def save_weights(filename: str, params: Params, cfg: LMConfig,
                 mesh=None) -> None:
    """Write weights in the Keras 2.3 ``save_weights`` HDF5 layout (the
    gather on every rank, the write on rank 0; see
    :func:`gather_params`)."""
    params = gather_params(params, mesh)
    if _is_writer():
        hdf5.write_file(filename, _weights_tree(params, cfg))


def save_config(filename: str, cfg: LMConfig, vocab: Vocab,
                history: Optional[Dict[str, Any]] = None) -> None:
    """Add the reference-schema ``config/`` group to an h5 file (in
    place of one it has): the file is read whole and written anew."""
    tree = hdf5.read_tree(filename) if os.path.exists(filename) \
        else {'items': {}}
    tree['items']['config'] = _config_group(cfg, vocab, history)
    hdf5.write_file(filename, tree)


def save_model(filename: str, params: Params, cfg: LMConfig, vocab: Vocab,
               history: Optional[Dict[str, Any]] = None,
               mesh=None) -> None:
    """Weights and config in one file, written in one pass (on rank 0;
    see :func:`gather_params`)."""
    params = gather_params(params, mesh)
    if not _is_writer():
        return
    tree = _weights_tree(params, cfg)
    tree['items']['config'] = _config_group(cfg, vocab, history)
    hdf5.write_file(filename, tree)


def load_model(filename: str
               ) -> Tuple[Params, LMConfig, Vocab, Dict[str, Any]]:
    cfg, vocab, history = load_config(filename)
    params = load_weights(filename, cfg)
    cfg = cfg.replace(voc_size=params['char_embedding'].shape[0])
    return params, cfg, vocab, history


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------


def _open_h5(filename: str) -> hdf5.File:
    """Open for reading with an actionable error for non-HDF5 files
    (e.g. a Keras 3 ``.keras`` archive, which is a zip, or a TF2
    ``.ckpt`` index) instead of a bare signature failure."""
    try:
        return hdf5.File(filename)
    except OSError as err:
        try:
            with open(filename, 'rb') as fh:
                magic = fh.read(4)
        except OSError:
            raise
        if magic == b'\x89HDF':
            # a GENUINE HDF5 file failing to open (locking,
            # truncation, permissions) is an I/O problem, not a
            # format problem — keep the original error type/message
            raise
        if magic[:2] == b'PK':
            raise ValueError(
                '%s: unsupported model format: this is a zip archive '
                '(Keras 3 ".keras" file), not an HDF5 checkpoint. '
                'Expected the Keras 2.3 save_weights layout the '
                'reference tool writes (TF 1.15 era); re-export the '
                'weights to that layout or train with this tool.'
                % filename) from err
        raise ValueError(
            '%s: not an HDF5 file (%s). Expected a Keras 2.3 h5 '
            'checkpoint as written by the reference tool or this '
            'one.' % (filename, err)) from err


def _layout_hint(f) -> str:
    """A one-line diagnosis of a recognisable-but-unsupported h5
    layout (Keras 3 ``.weights.h5``, TF2 object-graph h5), appended to
    rejection errors so users know WHAT they loaded, not just that it
    failed."""
    keys = set(f.keys())
    if {'layers', 'vars'} & keys or '_layer_checkpoint_dependencies' \
            in keys or any(isinstance(f.get(k), hdf5.Group) and
                           'vars' in f[k] for k in keys):
        return (' The file uses the Keras 3 ".weights.h5" layout '
                '(per-layer "vars" groups); only the Keras 2.3 '
                'save_weights layout (layer_names/weight_names '
                'attributes, as written by TF 1.15 or this tool) is '
                'supported — re-export accordingly.')
    if 'optimizer_weights' in keys and 'model_weights' not in keys:
        return (' The file looks like a Keras optimizer-state dump, '
                'not a weights checkpoint.')
    return ''


def load_config(filename: str
                ) -> Tuple[LMConfig, Vocab, Dict[str, Any]]:
    """Read the ``config/`` group; return (LMConfig, Vocab, history)."""
    with _open_h5(filename) as f:
        if 'config' not in f:
            raise ValueError(
                '%s: no "config" group: not a keraslm model file '
                '(expected config/{width,depth,length,stateful,'
                'variable_length,mapping} as written by the reference '
                'Rater.save, rating.py:918-945, or this tool).%s'
                % (filename, _layout_hint(f)))
        group = f['config']
        history = (json.loads(group['history'][()])
                   if 'history' in group else {})
        codepoints = group['mapping'][()]
        vocab = Vocab.from_codepoints(codepoints)
        if 'contexts' in group:
            contexts = tuple(tuple(int(v) for v in row)
                             for row in group['contexts'][()])
        else:
            contexts = ((200, 10),)
        extra = {}
        for key in _AWD_KEYS:
            if key in group:
                value = group[key][()]
                kind = type(getattr(LMConfig, key))
                extra[key] = tuple(int(v) for v in np.asarray(value)) \
                    if key == 'widths' else kind(value)
        cfg = LMConfig(
            width=int(group['width'][()]),
            depth=int(group['depth'][()]),
            length=int(group['length'][()]),
            voc_size=vocab.size,
            contexts=contexts,
            stateful=bool(group['stateful'][()]),
            variable_length=bool(group['variable_length'][()]),
            **extra)
    return cfg, vocab, history


def load_weights(filename: str, cfg: LMConfig) -> Params:
    """Read weights from a Keras-2.3-layout h5 file into a param pytree.

    Handles the byte-level variation genuine TF-1.15/Keras-2.3 files
    exhibit: fixed- or variable-length string attributes, chunked
    attributes (``layer_names0``, ``layer_names1``, ...), weightless
    layer groups (inputs, dropout, lambdas), ``model_weights/``
    nesting (full ``model.save`` files as opposed to ``save_weights``),
    CuDNNLSTM-trained files (layers auto-named ``cu_dnnlstm_<i>``, bias
    doubled to (8W,) — halves summed, the conversion Keras applies),
    and name-scope suffixes.  Like Keras' own ``load_weights``, layer
    matching is ultimately POSITIONAL over the layers that carry
    weights; exact names are only a fast path.  Gate order i, f, c, o
    throughout.
    """
    with _open_h5(filename) as f:
        root = f['model_weights'] if 'model_weights' in f else f
        layers = _collect_layer_weights(root)
        if not layers:
            raise ValueError(
                '%s: no weight-carrying layers found in the Keras 2.3 '
                'save_weights layout (layer_names/weight_names '
                'attributes).%s' % (filename, _layout_hint(f)))
        params: Params = {'context_embeddings': [], 'lstm': []}
        # classify by weight structure (Keras matches positionally, so
        # layer names may differ: lstm_1 vs cu_dnnlstm_1 vs scoped)
        embeddings = [(name, lw) for name, lw in layers
                      if set(lw) == {'embeddings'}]
        lstms = [(name, lw) for name, lw in layers
                 if 'kernel' in lw and 'recurrent_kernel' in lw]
        emb = _named(embeddings, 'char_embedding')
        if emb is None and embeddings:
            # positional: the char embedding is built first (reference
            # rating.py:104-114) and is the one with width columns
            wide = [lw['embeddings'] for _, lw in embeddings
                    if lw['embeddings'].shape[1] == cfg.width]
            emb = wide[0] if len(wide) == 1 \
                else embeddings[0][1]['embeddings']
        if emb is None:
            raise ValueError(
                '%s: no char embedding weight found' % filename)
        params['char_embedding'] = emb
        ctx_pos = [lw for name, lw in embeddings
                   if lw['embeddings'] is not emb]
        for i in range(cfg.n_contexts):
            cemb = _named(embeddings, 'context%d_embedding' % (i + 1))
            if cemb is None and i < len(ctx_pos):
                cemb = ctx_pos[i]['embeddings']
            if cemb is None:
                raise ValueError('%s: missing context%d_embedding'
                                 % (filename, i + 1))
            params['context_embeddings'].append(cemb)
        if len(lstms) < cfg.depth:
            raise ValueError('%s: found %d recurrent layers, need %d'
                             % (filename, len(lstms), cfg.depth))
        # resolve by name only when the names form a COMPLETE and
        # DISTINCT assignment; otherwise use positional order for all
        # depths.  (Per-depth name-then-positional mixing could assign
        # one file layer to two depths: with graph-uniquified names
        # lstm_2/lstm_3, depth 0 fell back positionally to lstm_2 and
        # depth 1 name-matched lstm_2 again.)
        chosen = [(_layer(lstms, 'lstm_%d' % (i + 1)) or
                   _layer(lstms, 'cu_dnnlstm_%d' % (i + 1)))
                  for i in range(cfg.depth)]
        if any(lw is None for lw in chosen) or \
                len({id(lw) for lw in chosen}) != cfg.depth:
            chosen = [lstms[i][1] for i in range(cfg.depth)]
        for i in range(cfg.depth):
            lw = chosen[i]
            kernel = lw.get('kernel')
            rec = lw.get('recurrent_kernel')
            bias = lw.get('bias')
            if kernel is None or rec is None or bias is None:
                raise ValueError('%s: incomplete LSTM layer %d weights'
                                 % (filename, i + 1))
            W = rec.shape[0]
            if bias.shape[0] == 8 * W:  # CuDNN double bias
                bias = bias[:4 * W] + bias[4 * W:]
            params['lstm'].append({
                'kernel': kernel, 'recurrent': rec, 'bias': bias})
        if cfg.head_bias:
            head = _layer(layers, 'char_output')
            if head is None or 'bias' not in head:
                raise ValueError('%s: the model has a head bias, the file '
                                 'no char_output/bias' % filename)
            params['head_bias'] = head['bias']
    return params


def _matches(name: str, target: str) -> bool:
    """Layer-name match tolerating name scopes ('model_1/lstm_1') and
    TF graph-uniquification suffixes ('lstm_1_1')."""
    tail = name.rsplit('/', 1)[-1]
    return tail == target or tail.startswith(target + '_')


def _named(layers, target) -> Optional[np.ndarray]:
    for name, lw in layers:
        if _matches(name, target) and 'embeddings' in lw:
            return lw['embeddings']
    return None


def _layer(layers, target) -> Optional[Dict[str, np.ndarray]]:
    for name, lw in layers:
        if _matches(name, target):
            return lw
    return None


def _read_attr_list(group, name) -> Optional[list]:
    """A Keras-written string-list attribute: plain, or chunked into
    ``<name>0``, ``<name>1``, ... when over 64KB (Keras
    ``load_attributes_from_hdf5_group``)."""
    if name in group.attrs:
        items = list(group.attrs[name])
    elif name + '0' in group.attrs:
        items = []
        chunk = 0
        while name + str(chunk) in group.attrs:
            items.extend(group.attrs[name + str(chunk)])
            chunk += 1
    else:
        return None
    return [n.decode('utf8') if isinstance(n, bytes) else str(n)
            for n in items]


def _collect_layer_weights(f) -> list:
    """Ordered [(layer name, {short weight name -> array})], only
    layers that carry weights (Keras' positional-matching set)."""
    out = []
    layer_names = _read_attr_list(f, 'layer_names')
    if layer_names is None:  # fall back to groups (skip config group)
        layer_names = [k for k in f.keys() if k != 'config']
    for name in layer_names:
        if name not in f:
            continue
        g = f[name]
        weights: Dict[str, np.ndarray] = {}
        for wname in _read_attr_list(g, 'weight_names') or []:
            if wname not in g:
                continue
            short = wname.split('/')[-1].split(':')[0]
            weights[short] = np.asarray(g[wname], dtype=np.float32)
        if weights:
            out.append((name, weights))
    return out
