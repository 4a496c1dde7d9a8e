// Native lattice-decode preparation: PAGE-lattice edge dicts -> the
// fused decode kernel's (E, A, L) input arrays + emission metadata.
//
// The host prep of the decode kernels: the same walk as the Python
// lane of ocrd_keraslm_torch/rater.py (_decode_scan,
// Rater._prepare_decode_edges, Rater._fill_decode_arrays,
// Rater._emit_path, taken with KERASLM_NATIVE=0) over the same
// TextEquiv objects, through the CPython C API.  Semantics are an exact
// replica (tests/test_torch_native.py holds the two lanes together):
//
//  * consecutive single-alternative edges merge into runs of at most
//    MERGE_MAX chars (per-char confidence bits preserved per piece);
//  * multi-alternative edges keep up to A alternatives with scalar
//    per-alternative confidence bits;
//  * chars map through the vocabulary's codepoint->id table (0 for
//    unmapped), confidences to -log2(conf) (missing conf -> 1.0);
//  * padding edges get one zero-length valid alternative.
//
// Loaded with ctypes.PyDLL (the GIL is held throughout; every call
// runs Python C API code).
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Names {
    PyObject* unicode;  // "Unicode"
    PyObject* conf;     // "conf"
    // dict keys cached once per call: PyDict_{Get,Set}ItemString
    // re-hashes (and for Set, re-creates) the key string on every edge
    PyObject* k_alternatives;
    PyObject* k_element;
    PyObject* k_alts;
    PyObject* k_parts;
};

Names make_names() {
    return Names{PyUnicode_FromString("Unicode"),
                 PyUnicode_FromString("conf"),
                 PyUnicode_FromString("alternatives"),
                 PyUnicode_FromString("element"),
                 PyUnicode_FromString("alts"),
                 PyUnicode_FromString("parts")};
}

void free_names(Names& n) {
    Py_DECREF(n.unicode);
    Py_DECREF(n.conf);
    Py_DECREF(n.k_alternatives);
    Py_DECREF(n.k_element);
    Py_DECREF(n.k_alts);
    Py_DECREF(n.k_parts);
}

double conf_bits(PyObject* te, const Names& n) {
    double conf = 1.0;
    PyObject* c = PyObject_GetAttr(te, n.conf);
    if (c) {
        if (c != Py_None) {
            double v = PyFloat_AsDouble(c);
            if (v == -1.0 && PyErr_Occurred()) {
                PyErr_Clear();
                v = 0.0;
            }
            conf = v;  // explicit 0.0 is preserved (None -> 1.0)
        }
        Py_DECREF(c);
    } else {
        PyErr_Clear();
    }
    if (conf < 1e-99) conf = 1e-99;
    return -std::log2(conf);
}

// borrowed: alternatives list of an edge dict, or nullptr on error
PyObject* edge_alternatives(PyObject* edge, const Names& n) {
    PyObject* alts = PyDict_GetItemWithError(edge, n.k_alternatives);
    if (!alts) {
        PyErr_Clear();
        return nullptr;
    }
    if (!PyList_Check(alts)) return nullptr;
    return alts;
}

Py_ssize_t te_length(PyObject* te, const Names& n) {
    PyObject* u = PyObject_GetAttr(te, n.unicode);
    if (!u) {
        PyErr_Clear();
        return 0;
    }
    Py_ssize_t len = PyUnicode_Check(u) ? PyUnicode_GET_LENGTH(u) : 0;
    Py_DECREF(u);
    return len;
}

}  // namespace

// Pass 1: count prepared edges and the longest alternative (in chars)
// after run merging.  Returns (n_prepared, maxlen) as a tuple.
extern "C" PyObject* decode_scan(PyObject* edges, int merge,
                                 int merge_max, long A) {
    Names names = make_names();
    Py_ssize_t nE = PyList_Size(edges);
    long n_prepared = 0;
    long maxlen = 1;
    long run_chars = -1;  // -1: no open run
    for (Py_ssize_t i = 0; i < nE; i++) {
        PyObject* edge = PyList_GET_ITEM(edges, i);
        PyObject* alts = edge_alternatives(edge, names);
        Py_ssize_t nA = alts ? PyList_Size(alts) : 0;
        if (merge && nA == 1) {
            long len = (long)te_length(PyList_GET_ITEM(alts, 0), names);
            if (run_chars >= 0 && run_chars + len <= merge_max) {
                run_chars += len;
            } else {
                if (run_chars >= 0) n_prepared++;
                run_chars = len;
            }
            if (run_chars > maxlen) maxlen = run_chars;
        } else {
            if (run_chars >= 0) {
                n_prepared++;
                run_chars = -1;
            }
            n_prepared++;
            // honor the same alternative cap the fill uses — a
            // hardcoded 4 would under-size maxlen (and the caller's
            // L bucket) if A were ever raised
            for (Py_ssize_t a = 0; a < nA && a < (Py_ssize_t)A; a++) {
                long len = (long)te_length(PyList_GET_ITEM(alts, a),
                                           names);
                if (len > maxlen) maxlen = len;
            }
        }
    }
    if (run_chars >= 0) n_prepared++;
    free_names(names);
    return Py_BuildValue("(ll)", n_prepared, maxlen);
}

// Pass 2: fill the (E, A, L) kernel arrays and build the emission
// metadata: a list of dicts {'alts', 'parts', 'element'} mirroring
// Rater._prepare_decode_edges output (minus alt_ids/alt_conf, which
// only feed the fill itself).
extern "C" PyObject* decode_fill(PyObject* edges, int merge,
                                 int merge_max, long E, long A, long L,
                                 const int32_t* table, int64_t tlen,
                                 int32_t* chars, float* mask,
                                 float* conf, float* valid) {
    Names names = make_names();
    PyObject* meta = PyList_New(0);
    Py_ssize_t nE = PyList_Size(edges);
    long ei = 0;  // prepared-edge index

    // open run state
    bool run_open = false;
    long run_chars = 0;        // total chars in the open run
    PyObject* run_parts = nullptr;   // list of (element, te, n)
    PyObject* run_alts = nullptr;    // borrowed->owned alternatives of 1st
    std::vector<int32_t> run_ids;
    std::vector<float> run_bits;

    auto write_alt = [&](long e, long a, const int32_t* ids,
                         const float* bits, long n) {
        long base = (e * A + a) * L;
        long lim = n < L ? n : L;
        for (long j = 0; j < lim; j++) {
            chars[base + j] = ids[j];
            mask[base + j] = 1.0f;
            conf[base + j] = bits[j];
        }
        valid[e * A + a] = 1.0f;
    };

    auto encode_te = [&](PyObject* te, std::vector<int32_t>& out) {
        PyObject* u = PyObject_GetAttr(te, names.unicode);
        if (!u || !PyUnicode_Check(u)) {
            PyErr_Clear();
            Py_XDECREF(u);
            return;
        }
        Py_ssize_t len = PyUnicode_GET_LENGTH(u);
        int kind = PyUnicode_KIND(u);
        const void* data = PyUnicode_DATA(u);
        for (Py_ssize_t j = 0; j < len; j++) {
            Py_UCS4 cp = PyUnicode_READ(kind, data, j);
            out.push_back(cp < (Py_UCS4)tlen ? table[cp] : 0);
        }
        Py_DECREF(u);
    };

    auto flush_run = [&]() {
        if (!run_open) return;
        write_alt(ei, 0, run_ids.data(), run_bits.data(),
                  (long)run_ids.size());
        if ((long)run_ids.size() == 0) valid[ei * A + 0] = 1.0f;
        PyObject* pe = PyDict_New();
        PyDict_SetItem(pe, names.k_alts, run_alts);
        PyDict_SetItem(pe, names.k_parts, run_parts);
        PyDict_SetItem(pe, names.k_element, Py_None);
        PyList_Append(meta, pe);
        Py_DECREF(pe);
        Py_DECREF(run_parts);
        Py_DECREF(run_alts);
        run_parts = nullptr;
        run_alts = nullptr;
        run_ids.clear();
        run_bits.clear();
        run_open = false;
        ei++;
    };

    std::vector<int32_t> tmp_ids;
    std::vector<float> tmp_bits;
    for (Py_ssize_t i = 0; i < nE; i++) {
        PyObject* edge = PyList_GET_ITEM(edges, i);
        PyObject* alts = edge_alternatives(edge, names);
        Py_ssize_t nA = alts ? PyList_Size(alts) : 0;
        PyObject* element = PyDict_GetItemWithError(edge,
                                                    names.k_element);
        if (!element) {
            PyErr_Clear();
            element = Py_None;
        }
        if (merge && nA == 1) {
            PyObject* te = PyList_GET_ITEM(alts, 0);
            tmp_ids.clear();
            encode_te(te, tmp_ids);
            long len = (long)tmp_ids.size();
            double bits = conf_bits(te, names);
            if (!(run_open && run_chars + len <= merge_max)) {
                flush_run();
                run_open = true;
                run_chars = 0;
                run_parts = PyList_New(0);
                run_alts = alts;
                Py_INCREF(run_alts);
            }
            run_chars += len;
            for (long j = 0; j < len; j++) {
                run_ids.push_back(tmp_ids[j]);
                run_bits.push_back((float)bits);
            }
            PyObject* part = Py_BuildValue(
                "(OOl)", element, te, len > 1 ? len : 1L);
            PyList_Append(run_parts, part);
            Py_DECREF(part);
        } else {
            flush_run();
            for (Py_ssize_t a = 0; a < nA && a < A; a++) {
                PyObject* te = PyList_GET_ITEM(alts, a);
                tmp_ids.clear();
                encode_te(te, tmp_ids);
                double bits = conf_bits(te, names);
                tmp_bits.assign(tmp_ids.size(), (float)bits);
                write_alt(ei, a, tmp_ids.data(), tmp_bits.data(),
                          (long)tmp_ids.size());
                // zero-length alternatives are still valid (free edge)
                valid[ei * A + a] = 1.0f;
            }
            PyObject* pe = PyDict_New();
            PyDict_SetItem(pe, names.k_alts,
                           alts ? alts : Py_None);
            PyDict_SetItem(pe, names.k_parts, Py_None);
            PyDict_SetItem(pe, names.k_element, element);
            PyList_Append(meta, pe);
            Py_DECREF(pe);
            ei++;
        }
    }
    flush_run();
    // padding edges: one zero-length free alternative
    for (; ei < E; ei++) valid[ei * A + 0] = 1.0f;
    free_names(names);
    return meta;
}

// Pass 3: path emission — the per-edge (element, textequiv, score)
// tuples from the walked choices + cumulative costs.  An exact replica
// of Rater._emit_path (rater.py): merged runs expand with a uniform
// per-char score, unmerged edges score the CHOSEN alternative by its
// character count; scores clamp at 1.0.
// Returns (path list, entropy).
extern "C" PyObject* decode_emit(PyObject* meta, const int64_t* choices,
                                 const double* costs, long n,
                                 double start_cost) {
    Names names = make_names();
    PyObject* path = PyList_New(0);
    double prev = start_cost;
    for (long i = 0; i < n; i++) {
        PyObject* pe = PyList_GET_ITEM(meta, i);
        double cum = costs[i];
        double diff = cum - prev;
        PyObject* parts = PyDict_GetItemWithError(pe, names.k_parts);
        // a FAILED lookup returns null WITH an exception set —
        // clear it before issuing more C API calls (the inverted
        // check could never fire)
        if (!parts && PyErr_Occurred()) PyErr_Clear();
        if (parts && parts != Py_None) {
            Py_ssize_t np_ = PyList_Size(parts);
            long total_chars = 0;
            for (Py_ssize_t p = 0; p < np_; p++) {
                PyObject* part = PyList_GET_ITEM(parts, p);
                total_chars += PyLong_AsLong(PyTuple_GET_ITEM(part, 2));
            }
            double score =
                std::pow(2.0, -diff / (total_chars ? total_chars : 1));
            if (score > 1.0) score = 1.0;
            PyObject* score_o = PyFloat_FromDouble(score);
            for (Py_ssize_t p = 0; p < np_; p++) {
                PyObject* part = PyList_GET_ITEM(parts, p);
                PyObject* tup = PyTuple_Pack(
                    3, PyTuple_GET_ITEM(part, 0),
                    PyTuple_GET_ITEM(part, 1), score_o);
                PyList_Append(path, tup);
                Py_DECREF(tup);
            }
            Py_DECREF(score_o);
        } else {
            PyObject* alts = PyDict_GetItemWithError(pe, names.k_alts);
            if (!alts || !PyList_Check(alts) || PyList_Size(alts) == 0) {
                PyErr_Clear();
                prev = cum;
                continue;
            }
            Py_ssize_t nA = PyList_Size(alts);
            Py_ssize_t ai = (Py_ssize_t)choices[i];
            if (ai >= nA) ai = nA - 1;
            PyObject* te = PyList_GET_ITEM(alts, ai);
            long len = (long)te_length(te, names);
            double score = std::pow(2.0, -diff / (len ? len : 1));
            if (score > 1.0) score = 1.0;
            PyObject* element =
                PyDict_GetItemWithError(pe, names.k_element);
            if (!element) {
                PyErr_Clear();
                element = Py_None;
            }
            PyObject* score_o = PyFloat_FromDouble(score);
            PyObject* tup = PyTuple_Pack(3, element, te, score_o);
            PyList_Append(path, tup);
            Py_DECREF(tup);
            Py_DECREF(score_o);
        }
        prev = cum;
    }
    double entropy = n > 0 ? costs[n - 1] - start_cost : 0.0;
    free_names(names);
    return Py_BuildValue("(Nd)", path, entropy);
}
