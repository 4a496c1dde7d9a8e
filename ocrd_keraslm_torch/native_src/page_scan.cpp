// Native PAGE-XML document pipeline: raw bytes -> structure arrays +
// linear decode lattice, in one C++ pass.
//
// This is the framework's native document loader (the analogue of the
// reference stack's C-backed ocrd_models/generateDS layer): for the
// serving-shaped workload (glyph/word-level alternative decoding of
// many pages), the record lanes do per-element work in Python; this
// scanner replaces it with a single byte-level pass that emits
//   * per-element / per-TextEquiv structure arrays with byte spans
//     (the Python side writes results back by SPLICING the original
//     bytes, so unmodeled content is preserved verbatim),
//   * the decoded text/id blobs (entities resolved),
//   * the linear lattice (same traversal, tokenisation-repair,
//     choice-filter, and run-merge semantics as the Python builders in
//     wrapper/rate.py + rater._prepare_decode_edges of
//     ocrd_keraslm_torch, which remain the parity-tested references), filled directly into the fused decode
//     kernel's (E, A, L) arrays.
//
// SCOPE: the scanner is deliberately conservative.  Anything outside
// the well-formed UTF-8 PAGE profile it understands (DOCTYPE with an
// internal subset, unknown entities, non-UTF-8 declarations, nested
// TextRegion, line/region decode levels) sets a bail reason and the
// caller falls back to the lxml path — correctness first, the fast
// lane only serves shapes it provably handles.  Plain DOCTYPE
// declarations are skipped and CDATA sections join <Unicode> text
// literally (both as the ElementTree lanes read them).
//
// Loaded with ctypes.PyDLL (GIL held; Python C API used for returns).
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <set>
#include <string>
#include <vector>

namespace {

enum Kind : int8_t { K_REGION = 0, K_LINE = 1, K_WORD = 2, K_GLYPH = 3 };

struct TE {
    int32_t owner = -1;
    double conf = NAN;       // NAN = attribute missing
    int32_t index = -1;      // -1 = attribute missing
    int64_t span_s = 0, span_e = 0;        // whole <TextEquiv> element
    int64_t conf_s = 0, conf_e = 0;        // conf attr VALUE span
    int64_t tag_insert = 0;  // after '<TextEquiv' (attr insertion)
    int64_t text_s = 0, text_e = 0;        // codepoints into text blob
};

struct El {
    Kind kind;
    int32_t parent = -1;
    // 0 = attribute missing, 1 = target value (right-to-left /
    // bottom-to-top), 2 = present with another value — the projection
    // "or"-chains fall through MISSING values but stop at any present
    // one, so missing and non-target must stay distinguishable
    int8_t rd = 0;
    int8_t tlo = 0;
    int64_t content_end = -1;  // offset of closing-tag '<'
    int64_t span_s = 0, span_e = 0;
    int8_t self_closing = 0;
    int64_t id_s = 0, id_e = 0;            // codepoints into id blob
    std::vector<int32_t> children;         // element indices
    // own TextEquiv te indices, DOCUMENT order (an element's own
    // TextEquivs follow its children, so a contiguous range over the
    // global te array cannot represent them)
    std::vector<int32_t> te_list;
};

// one lattice edge before run merging
struct Edge {
    int32_t elem = -1;        // -1: synthetic space edge
    char space = 0;           // ' ' or '\n' for synthetic edges
    std::vector<int32_t> alts;  // te indices (post choice-filter)
};

struct Doc {
    std::string buf;
    std::vector<El> els;
    std::vector<TE> tes;
    std::string text_blob;   // decoded te texts (UTF-8)
    int64_t text_cp = 0;     // codepoint length of text_blob
    std::string id_blob;
    int64_t id_cp = 0;
    std::vector<int32_t> regions;  // top-level region indices
    int8_t page_rd = 0, page_tlo = 0;
    int64_t pcgtsid_s = 0, pcgtsid_e = 0;  // value span (0,0 = none)
    int64_t root_tag_insert = -1;          // after '<PcGts' tag name
    int64_t root_content_start = -1;       // after root '>'
    int64_t lastchange_s = -1, lastchange_e = -1;  // text span
    int64_t created_missing = 1;
    int64_t creator_missing = 1;
    int64_t meta_insert = -1;  // before '</Metadata>'
    std::string bail;          // non-empty: fast lane unusable
    // lattice state (built by page_lattice)
    std::vector<Edge> edges;
    int n_raw_edges = 0;
    // merge layout (built by lattice scan, consumed by fill)
    int n_prep = 0;
    int maxlen = 1;
    // emission meta: per prepared edge
    std::vector<int8_t> edge_kind;     // 0 plain, 1 merged run
    std::vector<int32_t> edge_elem;    // plain: element (-1 space)
    // pieces of merged runs: (prep-edge, elem, te, n_chars)
    std::vector<int32_t> piece_edge, piece_elem, piece_te, piece_len;
    // synthetic-space char per piece / per plain edge (0 = not a
    // space): the kernel fill must encode the ACTUAL ' ' or '\n'
    std::vector<int8_t> piece_space;
    std::vector<int8_t> edge_space;
    // plain edges: alt te ids + char lengths, A columns
    std::vector<int32_t> alt_te, alt_len;
    // decode write-back + projection splice edits (page_apply),
    // consumed by page_emit
    struct EmitEdit { int64_t s, e; std::string rep; };
    std::vector<EmitEdit> apply_edits;
    // codepoint -> byte table of text_blob, built on first use
    // (text_blob is immutable after the scan; lattice, fill, and
    // apply all need the same table)
    std::vector<int64_t> t2b_cache;
    // Relation type=join pairs (Source/Target regionRef, unescaped):
    // the projection suppresses the newline between consecutive lines
    // whose boundary words are joined (wrapper/rate.py
    // page_update_higher_textequiv_levels region_unicode loop)
    std::vector<std::string> join_src, join_tgt;
};

bool starts(const std::string& b, size_t p, const char* s) {
    size_t n = std::strlen(s);
    return b.size() - p >= n && std::memcmp(b.data() + p, s, n) == 0;
}

bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// append one codepoint as UTF-8; returns codepoint count (1)
void put_utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
        out += (char)cp;
    } else if (cp < 0x800) {
        out += (char)(0xC0 | (cp >> 6));
        out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        out += (char)(0xE0 | (cp >> 12));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    } else {
        out += (char)(0xF0 | (cp >> 18));
        out += (char)(0x80 | ((cp >> 12) & 0x3F));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    }
}

// decode [s, e) of buf (raw XML text) into out, resolving entities;
// counts CODEPOINTS appended into *cp.  Returns false on unknown
// entities / malformed refs (caller bails).
bool unescape(const std::string& b, size_t s, size_t e,
              std::string& out, int64_t* cp) {
    for (size_t i = s; i < e;) {
        unsigned char c = b[i];
        if (c == '&') {
            size_t semi = b.find(';', i + 1);
            if (semi == std::string::npos || semi > e) return false;
            std::string ent = b.substr(i + 1, semi - i - 1);
            if (ent == "amp") out += '&';
            else if (ent == "lt") out += '<';
            else if (ent == "gt") out += '>';
            else if (ent == "quot") out += '"';
            else if (ent == "apos") out += '\'';
            else if (ent.size() > 1 && ent[0] == '#') {
                uint32_t v = 0;
                if (ent[1] == 'x' || ent[1] == 'X') {
                    if (ent.size() < 3) return false;
                    for (size_t k = 2; k < ent.size(); k++) {
                        char h = ent[k];
                        int d = h >= '0' && h <= '9' ? h - '0'
                              : h >= 'a' && h <= 'f' ? h - 'a' + 10
                              : h >= 'A' && h <= 'F' ? h - 'A' + 10 : -1;
                        if (d < 0) return false;
                        v = v * 16 + d;
                        if (v > 0x10FFFF) return false;  // pre-wrap
                    }
                } else {
                    for (size_t k = 1; k < ent.size(); k++) {
                        if (ent[k] < '0' || ent[k] > '9') return false;
                        v = v * 10 + (ent[k] - '0');
                        if (v > 0x10FFFF) return false;  // pre-wrap
                    }
                }
                // XML Char production (what lxml enforces): TAB/LF/CR,
                // BMP minus surrogates/FFFE/FFFF, supplementary planes.
                // Surrogates would also emit invalid UTF-8 and crash
                // the Py_BuildValue("s#") accessors downstream.
                bool ok = v == 0x9 || v == 0xA || v == 0xD ||
                          (v >= 0x20 && v <= 0xD7FF) ||
                          (v >= 0xE000 && v <= 0xFFFD) ||
                          (v >= 0x10000 && v <= 0x10FFFF);
                if (!ok) return false;
                put_utf8(out, v);
            } else {
                return false;
            }
            (*cp)++;
            i = semi + 1;
        } else if (c == '\r') {
            // XML line-ending normalization: \r\n and bare \r decode
            // to \n (entity-decoded &#13; stays CR, per spec)
            out += '\n';
            (*cp)++;
            i += (i + 1 < e && b[i + 1] == '\n') ? 2 : 1;
        } else {
            out += (char)c;
            // count only UTF-8 lead bytes as codepoints
            if ((c & 0xC0) != 0x80) (*cp)++;
            i++;
        }
    }
    return true;
}

struct Attr {
    std::string name;
    int64_t val_s = 0, val_e = 0;  // raw byte span inside quotes
};

// strip a namespace prefix from a tag name
std::string localname(const std::string& name) {
    size_t c = name.rfind(':');
    return c == std::string::npos ? name : name.substr(c + 1);
}

struct StackEnt {
    std::string local;
    int32_t elem = -1;    // index into els if a tracked element
    int32_t te = -1;      // index into tes if a TextEquiv
    int32_t uni_te = -1;  // owning te if a captured Unicode element
    int64_t tag_end = 0;  // offset just past the opening '>'
};

}  // namespace

extern "C" void page_free(PyObject* capsule) {
    delete (Doc*)PyCapsule_GetPointer(capsule, "keraslm.page");
}

// Scan the document; returns a capsule (bail reason inside) or NULL on
// hard errors.
extern "C" PyObject* page_open(const char* data, int64_t n) {
    Doc* d = new Doc();
    d->buf.assign(data, (size_t)n);
    const std::string& b = d->buf;
    size_t pos = 0;
    // UTF-8 BOM
    if (starts(b, 0, "\xEF\xBB\xBF")) pos = 3;

    std::vector<StackEnt> stack;
    std::vector<int8_t> te_seen;  // first-Unicode-captured flags
    bool root_seen = false;
    bool in_unicode = false;
    std::string uni_text;
    bool in_metadata = false;
    bool in_lastchange = false;
    size_t lastchange_raw_s = 0;
    // current <Relation> being collected (join pairs, see Doc);
    // committed at the Relation CLOSE so explicit Source/Target refs
    // take precedence over generic RegionRef children, exactly like
    // page.py parse_relations (refs[0]/refs[1] are fallbacks)
    bool rel_open = false;
    std::string rel_type, rel_src, rel_tgt, rel_ref1, rel_ref2;
    auto rel_commit = [&]() {
        const std::string& src = !rel_src.empty() ? rel_src : rel_ref1;
        const std::string& tgt = !rel_tgt.empty() ? rel_tgt : rel_ref2;
        if (rel_type == "join" && !src.empty() && !tgt.empty()) {
            d->join_src.push_back(src);
            d->join_tgt.push_back(tgt);
        }
        rel_open = false;
        rel_type.clear();
        rel_src.clear();
        rel_tgt.clear();
        rel_ref1.clear();
        rel_ref2.clear();
    };

    auto bail = [&](const char* why) {
        if (d->bail.empty()) d->bail = why;
    };

    while (pos < b.size() && d->bail.empty()) {
        if (b[pos] != '<') {
            size_t next = b.find('<', pos);
            if (next == std::string::npos) next = b.size();
            if (in_unicode) {
                if (!unescape(b, pos, next, uni_text, &d->text_cp))
                    bail("unknown entity in text");
            }
            pos = next;
            continue;
        }
        if (starts(b, pos, "<?")) {
            // a PI inside <Unicode> splits the text in lxml (.text
            // stops at the first child) — concatenating across it
            // would diverge from the parity lanes
            if (in_unicode) { bail("PI inside Unicode"); break; }
            size_t e = b.find("?>", pos);
            if (e == std::string::npos) { bail("unterminated PI"); break; }
            // only accept utf-8-ish declarations
            std::string pi = b.substr(pos, e - pos);
            size_t enc = pi.find("encoding");
            if (enc != std::string::npos &&
                pi.find("UTF-8", enc) == std::string::npos &&
                pi.find("utf-8", enc) == std::string::npos)
                bail("non-UTF-8 declaration");
            pos = e + 2;
            continue;
        }
        if (starts(b, pos, "<!--")) {
            if (in_unicode) { bail("comment inside Unicode"); break; }
            size_t e = b.find("-->", pos);
            if (e == std::string::npos) { bail("unterminated comment"); break; }
            pos = e + 3;
            continue;
        }
        if (starts(b, pos, "<![CDATA[")) {
            // CDATA: literal content, no entity resolution.  Inside
            // <Unicode> it joins the text exactly like lxml's .text
            // does; elsewhere it is ignorable character data.
            size_t e = b.find("]]>", pos + 9);
            if (e == std::string::npos) {
                bail("unterminated CDATA");
                break;
            }
            if (in_unicode) {
                uni_text.append(b, pos + 9, e - (pos + 9));
                for (size_t i = pos + 9; i < e; i++)
                    if (((unsigned char)b[i] & 0xC0) != 0x80)
                        d->text_cp++;
            }
            pos = e + 3;
            continue;
        }
        if (starts(b, pos, "<!DOCTYPE")) {
            if (in_unicode) { bail("DOCTYPE inside Unicode"); break; }
            size_t e = b.find('>', pos);
            size_t br = b.find('[', pos);
            if (br != std::string::npos && e != std::string::npos &&
                br < e) {
                // an internal subset may declare entities the
                // entity resolver above does not know — lxml would
                // resolve them, this lane cannot
                bail("DOCTYPE with internal subset");
                break;
            }
            if (e == std::string::npos) {
                bail("unterminated DOCTYPE");
                break;
            }
            pos = e + 1;
            continue;
        }
        if (starts(b, pos, "<!")) {
            bail("unknown markup declaration");
            break;
        }
        if (starts(b, pos, "</")) {
            size_t e = b.find('>', pos);
            if (e == std::string::npos) { bail("unterminated close tag"); break; }
            if (stack.empty()) { bail("unbalanced close tag"); break; }
            // NAME-match the close tag: blind popping on a mismatched
            // (count-balanced) document would finalize spans on the
            // wrong elements and splice corrupt output where the lxml
            // lanes raise XMLSyntaxError
            {
                size_t cn_s = pos + 2, cn_e = cn_s;
                while (cn_e < e && !is_ws(b[cn_e])) cn_e++;
                if (localname(b.substr(cn_s, cn_e - cn_s)) !=
                        stack.back().local) {
                    bail("mismatched close tag");
                    break;
                }
            }
            StackEnt& top = stack.back();
            if (top.elem >= 0) {
                El& el = d->els[top.elem];
                el.content_end = (int64_t)pos;
                el.span_e = (int64_t)(e + 1);
            } else if (top.te >= 0) {
                d->tes[top.te].span_e = (int64_t)(e + 1);
            } else if (top.uni_te >= 0) {
                // finalize the open Unicode text into the blob
                d->text_blob += uni_text;
                d->tes[top.uni_te].text_e = d->text_cp;
                in_unicode = false;
            } else if (top.local == "Relation" && rel_open) {
                rel_commit();
            } else if (top.local == "Metadata") {
                d->meta_insert = (int64_t)pos;
                in_metadata = false;
            } else if (top.local == "LastChange" && in_lastchange) {
                d->lastchange_s = (int64_t)lastchange_raw_s;
                d->lastchange_e = (int64_t)pos;
                in_lastchange = false;
            }
            stack.pop_back();
            pos = e + 1;
            continue;
        }
        // opening tag
        if (in_unicode) { bail("element inside Unicode"); break; }
        size_t p = pos + 1;
        size_t name_s = p;
        while (p < b.size() && !is_ws(b[p]) && b[p] != '>' && b[p] != '/')
            p++;
        if (p >= b.size()) { bail("unterminated tag"); break; }
        std::string name = b.substr(name_s, p - name_s);
        std::string local = localname(name);
        int64_t tag_name_end = (int64_t)p;
        // attributes
        std::vector<Attr> attrs;
        bool self_close = false;
        while (p < b.size()) {
            while (p < b.size() && is_ws(b[p])) p++;
            if (p >= b.size()) { bail("unterminated tag"); break; }
            if (b[p] == '>') { p++; break; }
            if (b[p] == '/') {
                if (p + 1 < b.size() && b[p + 1] == '>') {
                    self_close = true;
                    p += 2;
                    break;
                }
                bail("malformed tag");
                break;
            }
            size_t an_s = p;
            while (p < b.size() && b[p] != '=' && !is_ws(b[p]) &&
                   b[p] != '>')
                p++;
            std::string an = b.substr(an_s, p - an_s);
            while (p < b.size() && is_ws(b[p])) p++;
            if (p >= b.size() || b[p] != '=') { bail("attr without value"); break; }
            p++;
            while (p < b.size() && is_ws(b[p])) p++;
            if (p >= b.size() || (b[p] != '"' && b[p] != '\'')) {
                bail("unquoted attr");
                break;
            }
            char q = b[p];
            size_t v_s = ++p;
            while (p < b.size() && b[p] != q) p++;
            if (p >= b.size()) { bail("unterminated attr"); break; }
            attrs.push_back(Attr{an, (int64_t)v_s, (int64_t)p});
            p++;
        }
        if (!d->bail.empty()) break;
        size_t tag_end = p;

        auto attr_span = [&](const char* want, int64_t* s, int64_t* e) {
            for (const Attr& a : attrs) {
                if (localname(a.name) == want) {
                    *s = a.val_s;
                    *e = a.val_e;
                    return true;
                }
            }
            return false;
        };
        auto attr_str = [&](const char* want, std::string* out) {
            int64_t s, e;
            if (!attr_span(want, &s, &e)) return false;
            out->assign(b, (size_t)s, (size_t)(e - s));
            return true;
        };

        if (!root_seen) {
            if (local != "PcGts") { bail("root is not PcGts"); break; }
            std::string ns;
            // the PAGE pagecontent ns must be the DEFAULT xmlns: the
            // splice path emits unprefixed fragments, which would land
            // in no namespace under a prefix-bound document
            for (const Attr& a : attrs) {
                std::string v = b.substr((size_t)a.val_s,
                                         (size_t)(a.val_e - a.val_s));
                if (v.find("PAGE/gts/pagecontent") ==
                    std::string::npos)
                    continue;
                if (a.name == "xmlns")
                    ns = v;
                else if (starts(a.name, 0, "xmlns:")) {
                    bail("prefix-bound PAGE namespace");
                    break;
                }
            }
            if (!d->bail.empty()) break;
            if (ns.empty()) { bail("no default PAGE namespace"); break; }
            root_seen = true;
            if (!attr_span("pcGtsId", &d->pcgtsid_s, &d->pcgtsid_e))
                d->root_tag_insert = tag_name_end;
            d->root_content_start = (int64_t)tag_end;
            if (self_close) { bail("empty document"); break; }
            stack.push_back(StackEnt{local, -1, -1, -1,
                                     (int64_t)tag_end});
            pos = tag_end;
            continue;
        }

        int32_t parent_elem = -1;
        for (auto it = stack.rbegin(); it != stack.rend(); ++it) {
            if (it->elem >= 0) { parent_elem = it->elem; break; }
        }

        Kind kind;
        bool tracked = false;
        if (local == "TextRegion") { kind = K_REGION; tracked = true; }
        else if (local == "TextLine") { kind = K_LINE; tracked = true; }
        else if (local == "Word") { kind = K_WORD; tracked = true; }
        else if (local == "Glyph") { kind = K_GLYPH; tracked = true; }

        if (tracked) {
            // attachment requires the DIRECT XML parent (top of
            // stack), like the lxml lanes' direct-children findall:
            // a TextRegion inside a TableRegion, or a TextLine nested
            // through a wrapper element, is IGNORED there (bytes
            // survive via the splice) — adopting it to the nearest
            // tracked ancestor would decode elements the parity lanes
            // never touch
            const StackEnt* direct = stack.empty() ? nullptr
                                                   : &stack.back();
            if (kind == K_REGION) {
                if (direct && direct->elem >= 0 &&
                    d->els[direct->elem].kind == K_REGION) {
                    // DIRECT subregions feed the reading-order
                    // projection in the lxml lanes; this lane cannot
                    // reproduce that, so it must bail, not ignore
                    bail("nested TextRegion");
                } else if (!direct || direct->local != "Page") {
                    tracked = false;  // ignored subtree
                }
            } else if (!direct || direct->elem < 0 ||
                       (int)d->els[direct->elem].kind !=
                           (int)kind - 1) {
                tracked = false;  // ignored subtree
            } else {
                parent_elem = direct->elem;
            }
        }
        if (tracked) {
            El el;
            el.kind = kind;
            el.parent = parent_elem;
            el.span_s = (int64_t)pos;
            el.span_e = (int64_t)tag_end;
            el.self_closing = self_close;
            el.content_end = self_close ? -1 : 0;
            std::string v;
            // empty attribute = falsy in the projection or-chain
            if (attr_str("readingDirection", &v) && !v.empty())
                el.rd = v == "right-to-left" ? 1 : 2;
            if (attr_str("textLineOrder", &v) && !v.empty())
                el.tlo = v == "bottom-to-top" ? 1 : 2;
            int64_t ids, ide;
            el.id_s = el.id_e = d->id_cp;
            if (attr_span("id", &ids, &ide)) {
                el.id_s = d->id_cp;
                if (!unescape(b, (size_t)ids, (size_t)ide, d->id_blob,
                              &d->id_cp))
                    bail("bad id");
                el.id_e = d->id_cp;
            }
            int32_t idx = (int32_t)d->els.size();
            if (parent_elem >= 0)
                d->els[parent_elem].children.push_back(idx);
            else
                d->regions.push_back(idx);
            d->els.push_back(std::move(el));
            if (!self_close)
                stack.push_back(StackEnt{local, idx, -1, -1,
                                         (int64_t)tag_end});
            pos = tag_end;
            continue;
        }

        if (local == "TextEquiv" && parent_elem >= 0 &&
            !stack.empty() && stack.back().elem == parent_elem) {
            TE te;
            te.owner = parent_elem;
            te.span_s = (int64_t)pos;
            te.span_e = (int64_t)tag_end;
            te.tag_insert = tag_name_end;
            int64_t s, e;
            if (attr_span("conf", &s, &e)) {
                te.conf_s = s;
                te.conf_e = e;
                te.conf = std::strtod(b.substr((size_t)s,
                                               (size_t)(e - s)).c_str(),
                                      nullptr);
            }
            std::string v;
            if (attr_str("index", &v))
                te.index = (int32_t)std::strtol(v.c_str(), nullptr, 10);
            te.text_s = te.text_e = d->text_cp;
            int32_t ti = (int32_t)d->tes.size();
            d->els[parent_elem].te_list.push_back(ti);
            d->tes.push_back(te);
            te_seen.push_back(0);
            if (!self_close)
                stack.push_back(StackEnt{local, -1, ti, -1,
                                         (int64_t)tag_end});
            pos = tag_end;
            continue;
        }

        if (local == "Unicode" && !stack.empty() &&
            stack.back().te >= 0) {
            int32_t ti = stack.back().te;
            TE& te = d->tes[ti];
            // PAGE semantics: only the FIRST Unicode child counts
            // (the object model breaks after it, page.py)
            if (self_close || te_seen[ti]) {
                // a self-closing FIRST Unicode is the (empty) text
                // result; later siblings must not override it
                if (self_close) te_seen[ti] = 1;
                else
                    stack.push_back(StackEnt{local, -1, -1, -1,
                                             (int64_t)tag_end});
                pos = tag_end;
                continue;
            }
            te_seen[ti] = 1;
            in_unicode = true;
            uni_text.clear();
            te.text_s = d->text_cp;
            te.text_e = d->text_cp;
            stack.push_back(StackEnt{local, -1, -1, ti,
                                     (int64_t)tag_end});
            pos = tag_end;
            continue;
        }

        if (local == "Page") {
            std::string v;
            if (attr_str("readingDirection", &v) && !v.empty())
                d->page_rd = v == "right-to-left" ? 1 : 2;
            if (attr_str("textLineOrder", &v) && !v.empty())
                d->page_tlo = v == "bottom-to-top" ? 1 : 2;
            if (!self_close)
                stack.push_back(StackEnt{local, -1, -1, -1,
                                         (int64_t)tag_end});
            pos = tag_end;
            continue;
        }

        // ReadingOrder is semantically INERT for the pages this lane
        // serves: the lattice builder walks regions in document order
        // (all three lanes, like the reference graph builder), and the
        // projection only consults reading order for NESTED text
        // regions — which bail at scan separately.  Its subtree
        // (OrderedGroup/RegionRef*) falls through to the balanced
        // unknown-tag skip below and the splice preserves its bytes.
        // Relations are NOT inert: Relation type=join suppresses the
        // newline between consecutive LINES whose boundary words are
        // joined (wrapper/rate.py page_update_higher_textequiv_levels
        // region_unicode loop) — collect the pairs here; page_apply
        // and the Python _project honor them.  These tags only occur
        // inside Relations, so no enclosing-state flag is needed; the
        // generic unknown-tag skip below keeps the subtree balanced
        // and the splice preserves its bytes.
        if (local == "Relation") {
            rel_open = true;
            rel_src.clear();
            rel_tgt.clear();
            rel_ref1.clear();
            rel_ref2.clear();
            if (!attr_str("type", &rel_type))
                rel_type.clear();
            if (self_close)
                rel_commit();  // no refs possible: just reset
        } else if (rel_open && (local == "SourceRegionRef" ||
                                local == "TargetRegionRef" ||
                                local == "RegionRef")) {
            // RegionRef children are the schema's generic fallback
            // form (page.py parse_relations: refs[0]/refs[1]); a
            // ReadingOrder's RegionRefs never reach here (rel_open)
            int64_t rs, re2;
            if (attr_span("regionRef", &rs, &re2)) {
                std::string ref;
                int64_t cp_n = 0;
                if (!unescape(b, (size_t)rs, (size_t)re2, ref,
                              &cp_n)) {
                    bail("bad regionRef");
                    break;
                }
                if (local[0] == 'S')
                    rel_src = ref;
                else if (local[0] == 'T')
                    rel_tgt = ref;
                else if (rel_ref1.empty())
                    rel_ref1 = ref;
                else if (rel_ref2.empty())
                    rel_ref2 = ref;
            }
        }
        if (local == "Metadata") {
            in_metadata = true;
            if (!self_close)
                stack.push_back(StackEnt{local, -1, -1, -1,
                                         (int64_t)tag_end});
            pos = tag_end;
            continue;
        }
        if (in_metadata && local == "LastChange" && !self_close) {
            in_lastchange = true;
            lastchange_raw_s = tag_end;
            stack.push_back(StackEnt{local, -1, -1, -1,
                                     (int64_t)tag_end});
            pos = tag_end;
            continue;
        }
        if (in_metadata && local == "Created") d->created_missing = 0;
        if (in_metadata && local == "Creator") d->creator_missing = 0;

        // any other element: skip (balanced via stack) — content
        // outside Unicode is ignored, the splice preserves the bytes
        if (!self_close)
            stack.push_back(StackEnt{local, -1, -1, -1,
                                     (int64_t)tag_end});
        pos = tag_end;
    }

    // patch Unicode text ends: the close-tag branch above pops Unicode
    // stack entries flagged with bit 30 — handle them here instead
    // (single-pass bookkeeping): we already appended uni_text at close.
    // NOTE: the flagged-entry patching happens in the close branch via
    // the condition below; see close handling.
    if (d->bail.empty() && !stack.empty()) d->bail = "unbalanced tags";
    if (d->bail.empty() && !root_seen) d->bail = "no root";

    PyObject* cap = PyCapsule_New(d, "keraslm.page", page_free);
    return cap;
}

// ---------------------------------------------------------------------
// post-scan accessors
// ---------------------------------------------------------------------

namespace {

Doc* get_doc(PyObject* cap) {
    return (Doc*)PyCapsule_GetPointer(cap, "keraslm.page");
}

// Python str.split() whitespace: token count; sets *uws if any
// NON-ASCII whitespace codepoint occurs (then byte-level counting is
// not Python-equivalent and the caller must bail)
long py_token_count(const std::string& s, bool* uws) {
    long tokens = 0;
    bool in_tok = false;
    for (size_t i = 0; i < s.size();) {
        unsigned char c = s[i];
        bool ws;
        if (c < 0x80) {
            ws = (c == ' ' || (c >= 0x09 && c <= 0x0D) ||
                  (c >= 0x1C && c <= 0x1F));
            i++;
        } else {
            // decode the codepoint
            uint32_t cp = 0;
            int extra = (c & 0xE0) == 0xC0 ? 1
                      : (c & 0xF0) == 0xE0 ? 2 : 3;
            cp = c & (0x3F >> extra);
            for (int k = 0; k < extra && i + 1 + k < s.size(); k++)
                cp = (cp << 6) | (s[i + 1 + k] & 0x3F);
            i += 1 + extra;
            ws = cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
                 (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 ||
                 cp == 0x2029 || cp == 0x202F || cp == 0x205F ||
                 cp == 0x3000;
            if (ws) *uws = true;
        }
        if (!ws && !in_tok) tokens++;
        in_tok = !ws;
    }
    return tokens;
}

// codepoint -> byte offset table for a blob (built once per call)
std::vector<int64_t> cp_to_byte(const std::string& blob) {
    std::vector<int64_t> off;
    off.reserve(blob.size() + 1);
    for (size_t i = 0; i < blob.size(); i++)
        if (((unsigned char)blob[i] & 0xC0) != 0x80)
            off.push_back((int64_t)i);
    off.push_back((int64_t)blob.size());
    return off;
}

// the Doc's text_blob table, built once and cached (the blob is
// immutable after the scan; lattice, fill, and apply share it)
const std::vector<int64_t>& doc_t2b(Doc* d) {
    if (d->t2b_cache.empty() && !d->text_blob.empty())
        d->t2b_cache = cp_to_byte(d->text_blob);
    else if (d->t2b_cache.empty())
        d->t2b_cache.push_back(0);
    return d->t2b_cache;
}

// first te of an element after the PAGE index-sort rule (index = rank
// when ALL tes carry one); -1 if the element has no tes
int32_t first_te(const Doc* d, const El& el, std::vector<int32_t>* order) {
    order->assign(el.te_list.begin(), el.te_list.end());
    if (order->size() > 1) {
        bool all_indexed = true;
        for (int32_t ti : *order)
            if (d->tes[ti].index < 0) { all_indexed = false; break; }
        if (all_indexed) {
            std::stable_sort(order->begin(), order->end(),
                             [d](int32_t a, int32_t b) {
                                 return d->tes[a].index <
                                        d->tes[b].index;
                             });
        }
    }
    return order->empty() ? -1 : (*order)[0];
}

}  // namespace

extern "C" PyObject* page_bail(PyObject* cap) {
    Doc* d = get_doc(cap);
    if (!d) return nullptr;
    if (d->bail.empty()) Py_RETURN_NONE;
    return PyUnicode_FromString(d->bail.c_str());
}

// Scalars + blobs as one tuple.
extern "C" PyObject* page_joins(PyObject* cap) {
    // Relation type=join (src, tgt) regionRef pairs, document order
    Doc* d = get_doc(cap);
    if (!d) return nullptr;
    PyObject* out = PyList_New((Py_ssize_t)d->join_src.size());
    if (!out) return nullptr;
    for (size_t j = 0; j < d->join_src.size(); j++) {
        PyObject* pair = Py_BuildValue(
            "(s#s#)", d->join_src[j].data(),
            (Py_ssize_t)d->join_src[j].size(),
            d->join_tgt[j].data(),
            (Py_ssize_t)d->join_tgt[j].size());
        if (!pair) { Py_DECREF(out); return nullptr; }
        PyList_SET_ITEM(out, (Py_ssize_t)j, pair);
    }
    return out;
}

extern "C" PyObject* page_counts(PyObject* cap) {
    Doc* d = get_doc(cap);
    if (!d) return nullptr;
    return Py_BuildValue(
        "(nn s# s# ii (LL) L L (LL) L ii)",
        (Py_ssize_t)d->els.size(), (Py_ssize_t)d->tes.size(),
        d->text_blob.data(), (Py_ssize_t)d->text_blob.size(),
        d->id_blob.data(), (Py_ssize_t)d->id_blob.size(),
        (int)d->page_rd, (int)d->page_tlo,
        (long long)d->pcgtsid_s, (long long)d->pcgtsid_e,
        (long long)d->root_tag_insert,
        (long long)d->root_content_start,
        (long long)d->lastchange_s, (long long)d->lastchange_e,
        (long long)d->meta_insert,
        (int)d->created_missing, (int)d->creator_missing);
}

// Structure arrays (Python-allocated buffers).
extern "C" int64_t page_arrays(PyObject* cap,
                               int8_t* ekind, int32_t* eparent,
                               int8_t* erd, int8_t* etlo,
                               int64_t* econtent_end, int64_t* espan,
                               int8_t* eself, int64_t* eid,
                               int32_t* efirst_te,
                               int32_t* towner, double* tconf,
                               int32_t* tindex, int64_t* tspan,
                               int64_t* tconf_span,
                               int64_t* ttag_insert, int64_t* ttext) {
    Doc* d = get_doc(cap);
    if (!d) return -1;
    std::vector<int32_t> order;
    for (size_t i = 0; i < d->els.size(); i++) {
        const El& el = d->els[i];
        ekind[i] = (int8_t)el.kind;
        eparent[i] = el.parent;
        erd[i] = el.rd;
        etlo[i] = el.tlo;
        econtent_end[i] = el.content_end;
        espan[2 * i] = el.span_s;
        espan[2 * i + 1] = el.span_e;
        eself[i] = el.self_closing;
        eid[2 * i] = el.id_s;
        eid[2 * i + 1] = el.id_e;
        efirst_te[i] = first_te(d, el, &order);
    }
    for (size_t i = 0; i < d->tes.size(); i++) {
        const TE& te = d->tes[i];
        towner[i] = te.owner;
        tconf[i] = te.conf;
        tindex[i] = te.index;
        tspan[2 * i] = te.span_s;
        tspan[2 * i + 1] = te.span_e;
        tconf_span[2 * i] = te.conf_s;
        tconf_span[2 * i + 1] = te.conf_e;
        ttag_insert[i] = te.tag_insert;
        ttext[2 * i] = te.text_s;
        ttext[2 * i + 1] = te.text_e;
    }
    return 0;
}

// ---------------------------------------------------------------------
// lattice construction (levels: 3 = glyph, 2 = word)
// ---------------------------------------------------------------------

// Build the linear lattice + merge layout.  Returns
// (n_raw, n_prep, maxlen, n_pieces, n_warn) or the bail reason str.
extern "C" PyObject* page_lattice(PyObject* cap, int level, int merge,
                                  int merge_max) {
    Doc* d = get_doc(cap);
    if (!d) return nullptr;
    if (!d->bail.empty())
        return PyUnicode_FromString(d->bail.c_str());
    if (level != (int)K_GLYPH && level != (int)K_WORD)
        return PyUnicode_FromString("level not in fast lane");
    const std::vector<int64_t>& t2b = doc_t2b(d);
    auto text_of = [&](int32_t ti) {
        const TE& te = d->tes[ti];
        return d->text_blob.substr(
            (size_t)t2b[te.text_s],
            (size_t)(t2b[te.text_e] - t2b[te.text_s]));
    };
    long n_warn = 0;
    long n_problems = 0;
    d->edges.clear();

    // tokenisation problems (word level only: TextLine own text vs
    // ' '-joined word texts; _HIERARCHY gating means glyph level
    // never consults any problem — see wrapper/rate.py)
    // problems[line element] = own line text
    std::vector<int32_t> order;
    std::vector<std::string> line_problem(d->els.size());
    std::vector<int8_t> line_has_problem(d->els.size(), 0);
    if (level == (int)K_WORD) {
        for (size_t li = 0; li < d->els.size(); li++) {
            const El& line = d->els[li];
            if (line.kind != K_LINE) continue;
            int32_t own_te = first_te(d, line, &order);
            if (own_te < 0) continue;
            std::string own = text_of(own_te);
            if (own.empty()) continue;
            std::string joined;
            bool first = true;
            for (int32_t wi : line.children) {
                if (d->els[wi].kind != K_WORD) continue;
                if (!first) joined += ' ';
                first = false;
                int32_t wt = first_te(d, d->els[wi], &order);
                if (wt >= 0) joined += text_of(wt);
            }
            if (own == joined) continue;
            bool uws = false;
            long a = py_token_count(own, &uws);
            long b2 = py_token_count(joined, &uws);
            if (uws)
                return PyUnicode_FromString(
                    "non-ASCII whitespace in tokenisation check");
            if (a != b2) {
                line_problem[li] = own;
                line_has_problem[li] = 1;
                n_problems++;
            }
        }
    }

    // repair check (reference _repair_tokenisation): does the
    // annotated tokenisation continue without a space here?
    auto repair = [&](const std::string& tok, const std::string& conc,
                      const std::string& next_token) {
        // codepoint boundaries of tok
        std::vector<size_t> tb;
        for (size_t i = 0; i < tok.size(); i++)
            if (((unsigned char)tok[i]) < 0x80 ||
                (((unsigned char)tok[i]) & 0xC0) != 0x80)
                tb.push_back(i);
        tb.push_back(tok.size());
        // codepoint boundaries of conc suffixes
        std::vector<size_t> cb;
        for (size_t i = 0; i < conc.size(); i++)
            if (((unsigned char)conc[i]) < 0x80 ||
                (((unsigned char)conc[i]) & 0xC0) != 0x80)
                cb.push_back(i);
        cb.push_back(conc.size());
        long max_i = (long)std::min(tb.size(), cb.size()) - 1;
        long found = 0;
        for (long i = max_i; i >= 0; i--) {
            // conc[-i:] == tok[:i]  (codepoint-suffix vs prefix)
            size_t clen = cb[cb.size() - 1] - cb[cb.size() - 1 - i];
            size_t tlen2 = tb[i];
            if (clen == tlen2 &&
                std::memcmp(conc.data() + conc.size() - clen,
                            tok.data(), clen) == 0) {
                found = i;
                break;
            }
        }
        if (found > 0 &&
            tok.compare(tb[found], next_token.size(), next_token) == 0)
            return true;
        return false;
    };

    // choice filter (wrapper/rate.py _filter_choices): index-sorted,
    // cap 4, conf window 0.1 of the best, missing conf -> 1.0
    auto filtered = [&](const El& el, std::vector<int32_t>* out) {
        first_te(d, el, &order);
        out->clear();
        double conf0 = 0;
        for (size_t a = 0; a < order.size() && a < 4; a++) {
            double c = d->tes[order[a]].conf;
            if (std::isnan(c)) c = 1.0;
            if (a == 0) conf0 = c;
            if (conf0 - c < 0.1) out->push_back(order[a]);
        }
    };

    // traversal — an exact replica of page_get_linear_lattice_at
    std::string conc_line;   // first-alt concat since line start (word
                             // level repair window)
    std::vector<int32_t> alts;
    auto add_elem_edge = [&](int32_t ei) {
        const El& el = d->els[ei];
        filtered(el, &alts);
        Edge edge;
        edge.elem = ei;
        edge.alts = alts;
        if (!alts.empty()) conc_line += text_of(alts[0]);
        d->edges.push_back(std::move(edge));
    };
    auto add_space_edge = [&](char space) {
        Edge edge;
        edge.space = space;
        conc_line += space;
        d->edges.push_back(std::move(edge));
    };

    bool first_region = true;
    for (int32_t ri : d->regions) {
        const El& region = d->els[ri];
        bool first_line = true;
        if (region.children.empty()) n_warn++;
        for (int32_t li : region.children) {
            const El& line = d->els[li];
            if (line.kind != K_LINE) continue;
            if (line.children.empty()) n_warn++;
            conc_line.clear();
            bool first_word = true;
            for (int32_t wi : line.children) {
                const El& word = d->els[wi];
                if (word.kind != K_WORD) continue;
                int32_t wt = first_te(d, word, &order);
                if (!first_word || !first_line || !first_region) {
                    bool skip = false;
                    if (level == (int)K_WORD && !first_word &&
                        line_has_problem[li] && wt >= 0 &&
                        !text_of(wt).empty())
                        skip = repair(line_problem[li], conc_line,
                                      text_of(wt));
                    if (!skip)
                        add_space_edge(first_word ? '\n' : ' ');
                }
                if (level == (int)K_WORD) {
                    if (!word.te_list.empty())
                        add_elem_edge(wi);
                    else
                        n_warn++;
                    first_word = false;
                    continue;
                }
                if (word.children.empty()) n_warn++;
                for (int32_t gi : word.children) {
                    const El& glyph = d->els[gi];
                    if (glyph.kind != K_GLYPH) continue;
                    if (!glyph.te_list.empty())
                        add_elem_edge(gi);
                    else
                        n_warn++;
                }
                first_word = false;
            }
            first_line = false;
        }
        first_region = false;
    }
    d->n_raw_edges = (int)d->edges.size();

    // merge layout + emission meta (replica of native decode_scan /
    // decode_fill merging over the edge structs)
    d->edge_kind.clear();
    d->edge_elem.clear();
    d->piece_edge.clear();
    d->piece_elem.clear();
    d->piece_te.clear();
    d->piece_len.clear();
    d->piece_space.clear();
    d->edge_space.clear();
    d->alt_te.clear();
    d->alt_len.clear();
    long maxlen = 1;
    long run_chars = -1;
    std::vector<std::array<int32_t, 4>> run_pieces;  // te, elem, len, space
    auto te_cp = [&](int32_t ti) {
        return ti < 0 ? 1L
                      : (long)(d->tes[ti].text_e - d->tes[ti].text_s);
    };
    auto flush_run = [&]() {
        if (run_chars < 0) return;
        int ei = (int)d->edge_kind.size();
        d->edge_kind.push_back(1);
        d->edge_elem.push_back(-1);
        d->edge_space.push_back(0);
        // alt_te/alt_len are DENSE (n_prep x 4): merged edges carry
        // pad columns so plain edges index by prepared-edge position
        for (long a = 0; a < 4; a++) {
            d->alt_te.push_back(-2);
            d->alt_len.push_back(0);
        }
        for (auto& pc : run_pieces) {
            d->piece_edge.push_back(ei);
            d->piece_te.push_back(pc[0]);
            d->piece_elem.push_back(pc[1]);
            d->piece_len.push_back(pc[2]);
            d->piece_space.push_back((int8_t)pc[3]);
        }
        run_pieces.clear();
        run_chars = -1;
    };
    for (const Edge& edge : d->edges) {
        long nA = edge.elem < 0 ? 1 : (long)edge.alts.size();
        if (merge && nA == 1) {
            int32_t ti = edge.elem < 0 ? -1 : edge.alts[0];
            long len = te_cp(ti);
            if (!(run_chars >= 0 && run_chars + len <= merge_max)) {
                flush_run();
                run_chars = 0;
            }
            run_chars += len;
            if (run_chars > maxlen) maxlen = run_chars;
            run_pieces.push_back({ti, edge.elem,
                                  (int32_t)(len > 1 ? len : 1),
                                  (int32_t)edge.space});
        } else {
            flush_run();
            d->edge_kind.push_back(0);
            d->edge_elem.push_back(edge.elem);
            d->edge_space.push_back((int8_t)edge.space);
            for (long a = 0; a < 4; a++) {
                int32_t ti = (edge.elem < 0 && a == 0) ? -1
                    : (a < (long)edge.alts.size() ? edge.alts[a]
                                                  : -2);
                d->alt_te.push_back(ti);
                long len = ti == -2 ? 0 : te_cp(ti);
                d->alt_len.push_back((int32_t)len);
                if (ti != -2 && len > maxlen) maxlen = len;
            }
        }
    }
    flush_run();
    d->n_prep = (int)d->edge_kind.size();
    d->maxlen = (int)maxlen;
    return Py_BuildValue("(iiinii)", d->n_raw_edges, d->n_prep,
                         d->maxlen,
                         (Py_ssize_t)d->piece_edge.size(),
                         (int)n_warn, (int)n_problems);
}

// Fill the decode-kernel arrays + emission meta arrays.
extern "C" int64_t page_fill(PyObject* cap, const int32_t* table,
                             int64_t tlen, long E, long A, long L,
                             int32_t* chars, float* mask, float* conf,
                             float* valid, int8_t* edge_kind,
                             int32_t* edge_elem, int32_t* alt_te,
                             int32_t* alt_len, int32_t* piece_edge,
                             int32_t* piece_elem, int32_t* piece_te,
                             int32_t* piece_len) {
    Doc* d = get_doc(cap);
    if (!d) return -1;
    const std::vector<int64_t>& t2b = doc_t2b(d);

    // encode a te's text into ids via the codepoint table
    auto encode = [&](int32_t ti, std::vector<int32_t>* out) {
        out->clear();
        if (ti < 0) return;
        const TE& te = d->tes[ti];
        const char* s = d->text_blob.data() + t2b[te.text_s];
        const char* e = d->text_blob.data() + t2b[te.text_e];
        while (s < e) {
            unsigned char c = *s;
            uint32_t cp;
            if (c < 0x80) { cp = c; s++; }
            else {
                int extra = (c & 0xE0) == 0xC0 ? 1
                          : (c & 0xF0) == 0xE0 ? 2 : 3;
                cp = c & (0x3F >> extra);
                for (int k = 0; k < extra && s + 1 + k < e; k++)
                    cp = (cp << 6) | (s[1 + k] & 0x3F);
                s += 1 + extra;
            }
            out->push_back(cp < (uint32_t)tlen ? table[cp] : 0);
        }
    };
    auto bits_of = [&](int32_t ti) {
        double c = 1.0;
        if (ti >= 0) {
            c = d->tes[ti].conf;
            if (std::isnan(c)) c = 1.0;
        }
        if (c < 1e-99) c = 1e-99;
        return -std::log2(c);
    };

    long ei = 0;
    std::vector<int32_t> run_ids;
    std::vector<float> run_bits;
    std::vector<int32_t> tmp;
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
    auto space_id = [&](int8_t sp) {
        uint32_t cp = (uint32_t)(unsigned char)sp;
        return cp < (uint32_t)tlen ? table[cp] : 0;
    };
    // replay the recorded merge layout (same grouping as page_lattice
    // by construction: both derive from one pass over d->edges)
    size_t pi = 0;
    for (long k = 0; k < (long)d->edge_kind.size(); k++) {
        if (d->edge_kind[k] == 1) {
            run_ids.clear();
            run_bits.clear();
            while (pi < d->piece_edge.size() &&
                   d->piece_edge[pi] == (int32_t)k) {
                int32_t ti = d->piece_te[pi];
                if (ti < 0) {
                    run_ids.push_back(space_id(d->piece_space[pi]));
                    run_bits.push_back(0.0f);
                } else {
                    encode(ti, &tmp);
                    double bits = bits_of(ti);
                    for (int32_t id : tmp) {
                        run_ids.push_back(id);
                        run_bits.push_back((float)bits);
                    }
                }
                pi++;
            }
            write_alt(k, 0, run_ids.data(), run_bits.data(),
                      (long)run_ids.size());
            valid[k * A + 0] = 1.0f;
        } else {
            for (long a = 0; a < A && a < 4; a++) {
                int32_t ti = d->alt_te[k * 4 + a];
                if (ti == -2) continue;
                if (ti == -1) {
                    int32_t id = space_id(d->edge_space[k]);
                    float b0 = 0.0f;
                    write_alt(k, a, &id, &b0, 1);
                } else {
                    encode(ti, &tmp);
                    double bits = bits_of(ti);
                    std::vector<float> bb(tmp.size(), (float)bits);
                    write_alt(k, a, tmp.data(), bb.data(),
                              (long)tmp.size());
                }
                valid[k * A + a] = 1.0f;
            }
        }
    }
    ei = (long)d->edge_kind.size();
    // padding edges
    for (; ei < E; ei++) valid[ei * A + 0] = 1.0f;
    // meta copies; n == 0 guarded: an empty vector's data() may be
    // null, and memcpy's pointer args are declared nonnull even for
    // zero sizes (UBSAN: "null pointer passed as argument 2")
    auto copy_n = [](void *dst, const void *src, size_t n) {
        if (n) std::memcpy(dst, src, n);
    };
    copy_n(edge_kind, d->edge_kind.data(), d->edge_kind.size());
    copy_n(edge_elem, d->edge_elem.data(), d->edge_elem.size() * 4);
    copy_n(alt_te, d->alt_te.data(), d->alt_te.size() * 4);
    copy_n(alt_len, d->alt_len.data(), d->alt_len.size() * 4);
    copy_n(piece_edge, d->piece_edge.data(), d->piece_edge.size() * 4);
    copy_n(piece_elem, d->piece_elem.data(), d->piece_elem.size() * 4);
    copy_n(piece_te, d->piece_te.data(), d->piece_te.size() * 4);
    copy_n(piece_len, d->piece_len.data(), d->piece_len.size() * 4);
    return d->n_prep;
}

// ---------------------------------------------------------------------
// decode write-back + projection (native apply) and final emission
// ---------------------------------------------------------------------
// C++ replica of page_native.NativePageDoc.apply_decode/_project/
// fast_tostring's splice assembly (which remain the parity-tested
// references): the per-winner conf patches, loser deletes, and
// bottom-up text projection.  Float formatting is '%.6g' in both.

namespace {

std::string fmt_g6(double v) {
    char b[32];
    std::snprintf(b, sizeof b, "%.6g", v);
    return std::string(b);
}

void esc_text(const char* s, const char* e, std::string* out) {
    for (; s < e; s++) {
        char c = *s;
        if (c == '&') out->append("&amp;");
        else if (c == '<') out->append("&lt;");
        else if (c == '>') out->append("&gt;");
        else out->push_back(c);
    }
}

}  // namespace

// Winners + confidences + projection as stored splice edits.
// Returns (strlen, n_path) for the caller's ppl log line, or an
// error string.  choices/costs must hold >= n_prep entries.
extern "C" PyObject* page_apply(PyObject* cap, int level,
                                const int64_t* choices,
                                const double* costs, int64_t n,
                                double start_cost) {
    Doc* d = get_doc(cap);
    if (!d) return PyUnicode_FromString("no document");
    if (n < d->n_prep)
        return PyUnicode_FromString("short decode result");
    size_t n_els = d->els.size(), n_tes = d->tes.size();
    std::vector<int32_t> winner_te(n_els, -1);
    std::vector<double> winner_score(n_els, 0.0);
    long strlen_cp = 0, n_path = 0;
    auto diff = [&](long k) {
        return costs[k] - (k ? costs[k - 1] : start_cost);
    };
    // merged runs: uniform per-char score over the run
    if (!d->piece_edge.empty()) {
        std::vector<long> run_total(d->n_prep, 0);
        for (size_t p = 0; p < d->piece_edge.size(); p++)
            run_total[d->piece_edge[p]] += d->piece_len[p];
        for (size_t p = 0; p < d->piece_edge.size(); p++) {
            int32_t pe = d->piece_edge[p];
            long tot = run_total[pe] > 1 ? run_total[pe] : 1;
            double sc = std::pow(2.0, -diff(pe) / (double)tot);
            if (sc > 1.0) sc = 1.0;
            int32_t el = d->piece_elem[p];
            if (el >= 0) {
                winner_te[el] = d->piece_te[p];
                winner_score[el] = sc;
                const TE& te = d->tes[d->piece_te[p]];
                strlen_cp += (long)(te.text_e - te.text_s);
            } else {
                strlen_cp += 1;  // synthetic space counts 1 char
            }
            n_path += 1;
        }
    }
    // plain edges
    for (long k = 0; k < d->n_prep; k++) {
        if (d->edge_kind[k] != 0) continue;
        long n_alts = 0;
        for (long a = 0; a < 4; a++)
            if (d->alt_te[k * 4 + a] != -2) n_alts++;
        long mx = n_alts - 1 > 0 ? n_alts - 1 : 0;
        long ai = choices[k];
        if (ai > mx) ai = mx;
        if (ai < 0) ai = 0;
        int32_t te = d->alt_te[k * 4 + ai];
        long ln = d->alt_len[k * 4 + ai];
        double sc = std::pow(2.0, -diff(k) / (double)(ln > 1 ? ln : 1));
        if (sc > 1.0) sc = 1.0;
        int32_t el = d->edge_elem[k];
        if (el >= 0) {
            winner_te[el] = te;
            winner_score[el] = sc;
            strlen_cp += ln;
        } else {
            strlen_cp += 1;
        }
        n_path += 1;
    }

    d->apply_edits.clear();
    // loser TextEquiv deletes (owner decoded, not the winner),
    // ascending te index — same append order as the Python replica
    for (size_t ti = 0; ti < n_tes; ti++) {
        int32_t ow = d->tes[ti].owner;
        if (ow >= 0 && winner_te[ow] >= 0 &&
            winner_te[ow] != (int32_t)ti)
            d->apply_edits.push_back({d->tes[ti].span_s,
                                      d->tes[ti].span_e, ""});
    }
    // winner conf := score, ascending element index
    for (size_t ei = 0; ei < n_els; ei++) {
        if (winner_te[ei] < 0) continue;
        const TE& te = d->tes[winner_te[ei]];
        std::string sb = fmt_g6(winner_score[ei]);
        if (te.conf_e > te.conf_s)
            d->apply_edits.push_back({te.conf_s, te.conf_e, sb});
        else
            d->apply_edits.push_back({te.tag_insert, te.tag_insert,
                                      " conf=\"" + sb + "\""});
    }

    // ---- projection (replica of _project) ----
    const std::vector<int64_t>& t2b = doc_t2b(d);
    std::vector<int32_t> te_of(n_els);
    std::vector<double> conf_of(n_els);
    std::vector<int32_t> order_tmp;
    for (size_t ei = 0; ei < n_els; ei++) {
        if (winner_te[ei] >= 0) {
            te_of[ei] = winner_te[ei];
            conf_of[ei] = winner_score[ei];
        } else {
            int32_t ft = first_te(d, d->els[ei], &order_tmp);
            te_of[ei] = ft;
            double c = 1.0;
            if (ft >= 0) {
                c = d->tes[ft].conf;
                if (std::isnan(c)) c = 1.0;
            }
            conf_of[ei] = c;
        }
    }
    // 'or'-chain of layout attributes: first PRESENT value wins,
    // falling through missing (0) ancestors to the page default
    auto effective = [&](int8_t El::*attr, int8_t page_val,
                         int32_t ei) {
        int8_t eff = d->els[ei].*attr;
        int32_t anc = d->els[ei].parent;
        for (int it = 0; it < 3 && eff == 0 && anc >= 0; it++) {
            eff = d->els[anc].*attr;
            anc = d->els[anc].parent;
        }
        if (eff == 0) eff = page_val;
        return eff == 1;
    };
    std::vector<std::string> new_text(n_els);
    std::vector<double> new_conf(n_els, 0.0);
    std::vector<char> has_new(n_els, 0);
    auto el_text = [&](int32_t ei, std::string* out) {
        int32_t ti = te_of[ei];
        if (ti >= 0) {
            const TE& te = d->tes[ti];
            out->append(d->text_blob, t2b[te.text_s],
                        t2b[te.text_e] - t2b[te.text_s]);
        }
    };
    auto cur_text = [&](int32_t ei, std::string* out) {
        if (has_new[ei]) out->append(new_text[ei]);
        else el_text(ei, out);
    };
    auto cur_conf = [&](int32_t ei) {
        return has_new[ei] ? new_conf[ei] : conf_of[ei];
    };
    auto set_te = [&](int32_t ei, std::string text, double conf) {
        for (int32_t ti : d->els[ei].te_list)
            d->apply_edits.push_back({d->tes[ti].span_s,
                                      d->tes[ti].span_e, ""});
        std::string frag = "<TextEquiv conf=\"" + fmt_g6(conf) +
                           "\"><Unicode>";
        esc_text(text.data(), text.data() + text.size(), &frag);
        frag += "</Unicode></TextEquiv>";
        const El& el = d->els[ei];
        if (el.self_closing) {
            // '<Tag .../>' -> '<Tag ...>' + frag + '</Tag>' (XML
            // forbids whitespace inside '/>', so the tag always ends
            // with those two bytes).  The tag NAME ends at any XML
            // whitespace — including tab/CR/LF from pretty-printed
            // attributes — or '/' or '>'.
            std::string tag = d->buf.substr(
                el.span_s, el.span_e - el.span_s);
            size_t ne = 1;
            while (ne < tag.size() && !is_ws(tag[ne]) &&
                   tag[ne] != '>' && tag[ne] != '/')
                ne++;
            std::string name = tag.substr(1, ne - 1);
            d->apply_edits.push_back(
                {el.span_s, el.span_e,
                 tag.substr(0, tag.size() - 2) + ">" + frag +
                     "</" + name + ">"});
        } else {
            d->apply_edits.push_back({el.content_end, el.content_end,
                                      frag});
        }
        new_text[ei] = std::move(text);
        new_conf[ei] = conf;
        has_new[ei] = 1;
    };
    bool word_level = (level == 2);
    // Relation type=join pairs: "src\x1ftgt" of the boundary WORD ids
    // (document order, matching the lxml lane's line.get_Word())
    std::set<std::string> join_set;
    std::vector<int64_t> id_b2;
    if (!d->join_src.empty()) {
        id_b2 = cp_to_byte(d->id_blob);
        for (size_t j = 0; j < d->join_src.size(); j++)
            join_set.insert(d->join_src[j] + '\x1f' + d->join_tgt[j]);
    }
    auto id_of = [&](int32_t ei) {
        const El& el = d->els[ei];
        return d->id_blob.substr(
            (size_t)id_b2[el.id_s],
            (size_t)(id_b2[el.id_e] - id_b2[el.id_s]));
    };
    auto lines_joined = [&](int32_t prev_li, int32_t li) {
        if (join_set.empty()) return false;
        const std::vector<int32_t>& pw = d->els[prev_li].children;
        const std::vector<int32_t>& nw = d->els[li].children;
        if (pw.empty() || nw.empty()) return false;
        return join_set.count(id_of(pw.back()) + '\x1f' +
                              id_of(nw.front())) > 0;
    };
    std::vector<int32_t> lines, words, glyphs;
    for (size_t ri = 0; ri < n_els; ri++) {
        if (d->els[ri].kind != K_REGION) continue;
        lines = d->els[ri].children;
        if (effective(&El::tlo, d->page_tlo, (int32_t)ri))
            std::reverse(lines.begin(), lines.end());
        for (int32_t li : lines) {
            words = d->els[li].children;
            if (effective(&El::rd, d->page_rd, li))
                std::reverse(words.begin(), words.end());
            if (!word_level) {
                for (int32_t wi : words) {
                    glyphs = d->els[wi].children;
                    if (effective(&El::rd, d->page_rd, wi))
                        std::reverse(glyphs.begin(), glyphs.end());
                    std::string text;
                    double conf = 0.0;
                    for (int32_t gi : glyphs) {
                        el_text(gi, &text);
                        conf += conf_of[gi];
                    }
                    if (!glyphs.empty()) conf /= (double)glyphs.size();
                    set_te(wi, std::move(text), conf);
                }
            }
            std::string line_text;
            double line_conf = 0.0;
            for (size_t k = 0; k < words.size(); k++) {
                if (k) line_text += ' ';
                cur_text(words[k], &line_text);
                line_conf += cur_conf(words[k]);
            }
            if (!words.empty()) line_conf /= (double)words.size();
            set_te(li, std::move(line_text), line_conf);
        }
        std::string region_text;
        double region_conf = 0.0;
        for (size_t k = 0; k < lines.size(); k++) {
            if (k && !lines_joined(lines[k - 1], lines[k]))
                region_text += '\n';
            cur_text(lines[k], &region_text);
            region_conf += cur_conf(lines[k]);
        }
        if (!lines.empty()) region_conf /= (double)lines.size();
        set_te((int32_t)ri, std::move(region_text), region_conf);
    }
    return Py_BuildValue("(ll)", strlen_cp, n_path);
}

// Final output assembly: the stored apply edits merged with the
// caller's extra edits (lastchange, metadata fragment, pcGtsId — a
// Python list of (start, end, bytes)), stable-sorted and spliced into
// the original bytes.  Returns bytes, or an error string on
// overlapping edits.
extern "C" PyObject* page_emit(PyObject* cap, PyObject* extra) {
    Doc* d = get_doc(cap);
    if (!d) return PyUnicode_FromString("no document");
    // the apply edits carry ~page-sized replacement strings: sort an
    // index over [apply_edits | extra] instead of deep-copying them.
    // Index order preserves the stable-sort tie semantics (apply
    // edits first, each list in insertion order).
    std::vector<Doc::EmitEdit> extra_edits;
    if (extra && extra != Py_None) {
        PyObject* seq = PySequence_Fast(extra, "extra edits");
        if (!seq) return nullptr;
        Py_ssize_t ne = PySequence_Fast_GET_SIZE(seq);
        extra_edits.reserve((size_t)ne);
        for (Py_ssize_t i = 0; i < ne; i++) {
            PyObject* it = PySequence_Fast_GET_ITEM(seq, i);
            long long s, e;
            const char* rep;
            Py_ssize_t rn;
            if (!PyArg_ParseTuple(it, "LLy#", &s, &e, &rep, &rn)) {
                Py_DECREF(seq);
                return nullptr;
            }
            extra_edits.push_back({(int64_t)s, (int64_t)e,
                                   std::string(rep, (size_t)rn)});
        }
        Py_DECREF(seq);
    }
    std::vector<const Doc::EmitEdit*> order;
    order.reserve(d->apply_edits.size() + extra_edits.size());
    for (const auto& ed : d->apply_edits) order.push_back(&ed);
    for (const auto& ed : extra_edits) order.push_back(&ed);
    std::stable_sort(order.begin(), order.end(),
                     [](const Doc::EmitEdit* a,
                        const Doc::EmitEdit* b) {
                         return a->s != b->s ? a->s < b->s
                                             : a->e < b->e;
                     });
    std::string out;
    out.reserve(d->buf.size() + 4096);
    int64_t pos = 0;
    for (const Doc::EmitEdit* ed : order) {
        if (ed->s < pos)
            return PyUnicode_FromString("overlapping splice edits");
        out.append(d->buf, pos, ed->s - pos);
        out.append(ed->rep);
        pos = ed->e;
    }
    out.append(d->buf, pos, d->buf.size() - pos);
    return PyBytes_FromStringAndSize(out.data(),
                                     (Py_ssize_t)out.size());
}
