// Native wire->tensor pump: serialized boxcar JSON -> columnar op staging.
//
// The serving path's per-op host cost in Python was ~40us/op (PERF.md):
// JSON parse, envelope walks, client-id interning, per-op HostOp objects.
// The reference keeps this thin by doing socket->kafka->deli in native code
// (alfred submitOp -> librdkafka producer, lambdas/src/alfred/index.ts:305;
// deli/lambda.ts:142 ticket loop is the only per-op compute). This file is
// the TPU analog: ONE pass over the raw boxcar bytes fills int32 columns
// [NF, N] that the Python side turns into device tensors with pure numpy --
// no per-op Python objects anywhere on the admitted fast path.
//
// Scope discipline: the pump models the COMMON wire shapes (join, text
// merge ops, LWW map/cell/counter ops, plain client ops). Anything else --
// leaves (window-cut semantics), group ops, items payloads, malformed
// frames -- sets F_FALLBACK on the row and the Python side routes that
// document's backlog through the existing object path, preserving exact
// slow-path behavior for the rare shapes.
//
// Loaded with ctypes.PyDLL (GIL held: we touch Python objects at the
// boundary only; the parse core runs on raw char buffers).

#define PY_SSIZE_T_CLEAN  // '#' formats take Py_ssize_t lengths
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

enum Col {
  C_DOC = 0,    // pump document ordinal
  C_KIND,       // ticket MsgKind (server/ticket_kernel.py)
  C_CLIENT,     // per-document client ordinal (join: the joining client)
  C_CSEQ,       // clientSequenceNumber
  C_REFSEQ,     // referenceSequenceNumber
  C_FAMILY,     // 0 none, 1 merge, 2 lww
  C_CHAN,       // channel ordinal (doc, store, channel) or -1
  C_MKIND,      // merge OpKind / LwwKind
  C_POS1,       // merge pos1 / lww key ordinal
  C_POS2,       // merge pos2 / lww delta
  C_TEXTOFF,    // insert text: byte offset into the arena (-1 none)
  C_TEXTLEN,    // insert text: byte length in the arena
  C_CHARLEN,    // insert text: codepoint count (device new_len)
  C_FLAGS,      // F_* bits
  C_BUF,        // input buffer index
  C_MSTART,     // whole-message JSON span (lazy materialization)
  C_MEND,
  C_PSTART,     // raw span: merge props / annotate props / lww value
  C_PEND,
  NF
};

enum Flag {
  F_FALLBACK = 1,  // route this document through the Python slow path
  F_MARKER = 2,    // merge insert is a marker segment
  F_PROPS = 4,     // PSTART/PEND span is present
  F_VALUE = 8,     // lww op carried a "value" key
  F_RUN = 16,      // merge insert payload is a stable-id run (matrix axis);
                   // PSTART/PEND span the raw run array
  F_ITEMS = 32,    // merge insert payload is an item-value array
                   // (sharedSequence SubSequence); PSTART/PEND span it
};

// MsgKind (server/ticket_kernel.py)
enum { K_NOOP = 0, K_OP = 1, K_JOIN = 2, K_LEAVE = 3, K_SYSTEM = 4 };
// OpKind (mergetree/oppack.py)
enum { M_INSERT = 1, M_REMOVE = 2, M_ANNOTATE = 3 };
// LwwKind (server/lww_kernel.py)
enum { LW_SET = 1, LW_DELETE = 2, LW_CLEAR = 3, LW_ADD = 4 };
enum { FAM_NONE = 0, FAM_MERGE = 1, FAM_LWW = 2 };

constexpr long kInt32Min = INT32_MIN;
constexpr long kInt32Max = INT32_MAX;

struct Ctx {
  std::unordered_map<std::string, int32_t> docs;
  std::vector<std::unordered_map<std::string, int32_t>> doc_clients;
  std::vector<int32_t> doc_next_ord;
  // (doc_ord "\x1f" store "\x1f" channel) -> channel ordinal
  std::unordered_map<std::string, int32_t> channels;
  std::unordered_map<std::string, int32_t> lww_keys;

  // per-parse outputs
  std::vector<int32_t> cols[NF];
  std::string arena;
  PyObject* new_docs = nullptr;      // [(ord, name)]
  PyObject* new_clients = nullptr;   // [(doc_ord, ord, client_id)]
  PyObject* new_channels = nullptr;  // [(ord, doc_ord, store, channel)]
  PyObject* new_keys = nullptr;      // [(ord, key)]
};

void clear_outputs(Ctx* ctx) {
  for (auto& c : ctx->cols) c.clear();
  ctx->arena.clear();
  Py_CLEAR(ctx->new_docs);
  Py_CLEAR(ctx->new_clients);
  Py_CLEAR(ctx->new_keys);
  Py_CLEAR(ctx->new_channels);
  ctx->new_docs = PyList_New(0);
  ctx->new_clients = PyList_New(0);
  ctx->new_channels = PyList_New(0);
  ctx->new_keys = PyList_New(0);
}

// ---------------------------------------------------------------------------
// JSON scanning over raw bytes
// ---------------------------------------------------------------------------

struct P {
  const char* s;  // buffer start (spans are offsets from here)
  const char* p;
  const char* e;
  bool bad = false;  // structural failure: caller falls back
};

inline void ws(P& c) {
  while (c.p < c.e && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' ||
                       *c.p == '\r'))
    ++c.p;
}

inline bool eat(P& c, char ch) {
  ws(c);
  if (c.p < c.e && *c.p == ch) {
    ++c.p;
    return true;
  }
  return false;
}

inline bool peek(P& c, char ch) {
  ws(c);
  return c.p < c.e && *c.p == ch;
}

struct Span {
  int32_t a = -1, b = -1;
  bool present() const { return a >= 0; }
  long len() const { return b - a; }
};

inline int hexval(char ch);

// String token at the cursor; out = INNER span (between the quotes);
// esc = whether any backslash escape occurred. STRICT JSON: escapes are
// validated and raw control chars rejected here, because raw string
// spans (props/items/lww values) are re-parsed host-side with strict
// json.loads — anything admitted laxly would defer a JSONDecodeError
// from ingest (contained) to materialization (uncontained).
bool str_token(P& c, Span* out, bool* esc) {
  ws(c);
  if (c.p >= c.e || *c.p != '"') {
    c.bad = true;
    return false;
  }
  const char* q = ++c.p;
  *esc = false;
  while (c.p < c.e) {
    const unsigned char ch = static_cast<unsigned char>(*c.p);
    if (ch == '\\') {
      *esc = true;
      if (c.p + 1 >= c.e) break;
      const char e = c.p[1];
      if (e == '"' || e == '\\' || e == '/' || e == 'b' || e == 'f' ||
          e == 'n' || e == 'r' || e == 't') {
        c.p += 2;
        continue;
      }
      if (e == 'u' && c.p + 6 <= c.e && hexval(c.p[2]) >= 0 &&
          hexval(c.p[3]) >= 0 && hexval(c.p[4]) >= 0 &&
          hexval(c.p[5]) >= 0) {
        c.p += 6;
        continue;
      }
      break;  // invalid escape: strict JSON rejects this string
    }
    if (ch == '"') {
      out->a = static_cast<int32_t>(q - c.s);
      out->b = static_cast<int32_t>(c.p - c.s);
      ++c.p;
      return true;
    }
    if (ch < 0x20) break;  // unescaped control char: strict JSON rejects
    ++c.p;
  }
  c.bad = true;
  return false;
}

inline void utf8_append(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

inline int hexval(char ch) {
  if (ch >= '0' && ch <= '9') return ch - '0';
  if (ch >= 'a' && ch <= 'f') return ch - 'a' + 10;
  if (ch >= 'A' && ch <= 'F') return ch - 'A' + 10;
  return -1;
}

// Validate UTF-8 over [a, b). Interned strings and arena text cross into
// Python as str objects; an invalid byte sequence would otherwise raise
// UnicodeDecodeError OUT of pump_parse, aborting the whole flush (every
// innocent frame in the batch) instead of falling the one frame back.
bool utf8_valid(const char* a, const char* b) {
  while (a < b) {
    uint8_t c0 = static_cast<uint8_t>(*a);
    if (c0 < 0x80) {
      ++a;
      continue;
    }
    int cont;
    uint32_t min_cp;
    if ((c0 & 0xE0) == 0xC0) {
      cont = 1;
      min_cp = 0x80;
    } else if ((c0 & 0xF0) == 0xE0) {
      cont = 2;
      min_cp = 0x800;
    } else if ((c0 & 0xF8) == 0xF0) {
      cont = 3;
      min_cp = 0x10000;
    } else {
      return false;
    }
    uint32_t cp = c0 & (0x3F >> cont);
    for (int i = 1; i <= cont; ++i) {
      if (a + i >= b) return false;
      uint8_t cc = static_cast<uint8_t>(a[i]);
      if ((cc & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (cp < min_cp || cp > 0x10FFFF ||
        (cp >= 0xD800 && cp < 0xE000))
      return false;
    a += cont + 1;
  }
  return true;
}

// Unescape the inner span of a JSON string into out (UTF-8); counts
// CODEPOINTS (Python len semantics: one astral char == 1). Returns false on
// a malformed escape.
bool unescape(const char* a, const char* b, std::string* out, long* chars) {
  long n = 0;
  while (a < b) {
    char ch = *a;
    if (ch != '\\') {
      out->push_back(ch);
      // Count a codepoint at every non-continuation byte.
      if ((static_cast<uint8_t>(ch) & 0xC0) != 0x80) ++n;
      ++a;
      continue;
    }
    if (a + 1 >= b) return false;
    char esc = a[1];
    a += 2;
    switch (esc) {
      case '"': out->push_back('"'); ++n; break;
      case '\\': out->push_back('\\'); ++n; break;
      case '/': out->push_back('/'); ++n; break;
      case 'b': out->push_back('\b'); ++n; break;
      case 'f': out->push_back('\f'); ++n; break;
      case 'n': out->push_back('\n'); ++n; break;
      case 'r': out->push_back('\r'); ++n; break;
      case 't': out->push_back('\t'); ++n; break;
      case 'u': {
        if (a + 4 > b) return false;
        int h0 = hexval(a[0]), h1 = hexval(a[1]), h2 = hexval(a[2]),
            h3 = hexval(a[3]);
        if (h0 < 0 || h1 < 0 || h2 < 0 || h3 < 0) return false;
        uint32_t cp = (h0 << 12) | (h1 << 8) | (h2 << 4) | h3;
        a += 4;
        if (cp >= 0xD800 && cp < 0xDC00) {  // high surrogate
          if (a + 6 > b || a[0] != '\\' || a[1] != 'u') return false;
          int g0 = hexval(a[2]), g1 = hexval(a[3]), g2 = hexval(a[4]),
              g3 = hexval(a[5]);
          if (g0 < 0 || g1 < 0 || g2 < 0 || g3 < 0) return false;
          uint32_t lo = (g0 << 12) | (g1 << 8) | (g2 << 4) | g3;
          if (lo < 0xDC00 || lo > 0xDFFF) return false;
          cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
          a += 6;
        } else if (cp >= 0xDC00 && cp < 0xE000) {
          return false;  // lone low surrogate
        }
        utf8_append(out, cp);
        ++n;
        break;
      }
      default:
        return false;
    }
  }
  *chars = n;
  return true;
}

// Integer token; false (non-fatal) when the value is a float/exponent,
// an overflowing integer, or not a number at all. STRICT JSON number
// grammar — leading zeros, bare '.'/'e' tails, and '1.2.3'-style
// multi-dot tails set c.bad so the frame falls back to the slow path's
// strict parse + poison containment instead of being admitted with a
// span json.loads would later reject.
bool int_token(P& c, long* out, bool* is_number) {
  ws(c);
  *is_number = false;
  const char* q = c.p;
  bool neg = false;
  if (q < c.e && *q == '-') {
    neg = true;
    ++q;
  }
  if (q >= c.e || *q < '0' || *q > '9') {
    c.bad = true;
    return false;
  }
  long v = 0;
  bool overflow = false;
  if (*q == '0') {
    ++q;
    if (q < c.e && *q >= '0' && *q <= '9') {
      c.bad = true;  // leading zero: strict JSON rejects
      return false;
    }
  } else {
    while (q < c.e && *q >= '0' && *q <= '9') {
      if (v > (LONG_MAX - 9) / 10) overflow = true;
      else v = v * 10 + (*q - '0');
      ++q;
    }
  }
  bool fractional = false;
  if (q < c.e && *q == '.') {
    fractional = true;
    ++q;
    if (q >= c.e || *q < '0' || *q > '9') {
      c.bad = true;  // '.' must be followed by a digit
      return false;
    }
    while (q < c.e && *q >= '0' && *q <= '9') ++q;
  }
  if (q < c.e && (*q == 'e' || *q == 'E')) {
    fractional = true;
    ++q;
    if (q < c.e && (*q == '+' || *q == '-')) ++q;
    if (q >= c.e || *q < '0' || *q > '9') {
      c.bad = true;  // exponent must have digits
      return false;
    }
    while (q < c.e && *q >= '0' && *q <= '9') ++q;
  }
  // Trailing-garbage guard: after a complete JSON number the next char
  // can only be structural (ws , ] } or end). '1.2.3', '1e5e3', '123abc'
  // must set c.bad HERE — callers that trust a true skip without
  // re-checking the following punctuation would otherwise admit a
  // silently truncated span.
  if (q < c.e) {
    const char nx = *q;
    if (nx == '.' || nx == '+' || nx == '-' ||
        (nx >= '0' && nx <= '9') || (nx >= 'a' && nx <= 'z') ||
        (nx >= 'A' && nx <= 'Z')) {
      c.bad = true;
      return false;
    }
  }
  c.p = q;
  *is_number = true;
  if (fractional || overflow) return false;
  *out = neg ? -v : v;
  return true;
}

bool skip_value(P& c, int depth = 0);

bool skip_object_or_array(P& c, char open, char close, int depth) {
  ++c.p;  // past open
  ws(c);
  if (c.p < c.e && *c.p == close) {
    ++c.p;
    return true;
  }
  while (c.p < c.e) {
    if (open == '{') {
      Span k;
      bool esc;
      if (!str_token(c, &k, &esc)) return false;
      if (!eat(c, ':')) {
        c.bad = true;
        return false;
      }
    }
    if (!skip_value(c, depth + 1)) return false;
    if (eat(c, ',')) continue;
    if (eat(c, close)) return true;
    c.bad = true;
    return false;
  }
  c.bad = true;
  return false;
}

bool skip_value(P& c, int depth) {
  if (depth > 96) {
    c.bad = true;
    return false;
  }
  ws(c);
  if (c.p >= c.e) {
    c.bad = true;
    return false;
  }
  char ch = *c.p;
  if (ch == '"') {
    Span sp;
    bool esc;
    return str_token(c, &sp, &esc);
  }
  if (ch == '{') return skip_object_or_array(c, '{', '}', depth);
  if (ch == '[') return skip_object_or_array(c, '[', ']', depth);
  if (ch == 't') {
    if (c.e - c.p >= 4 && std::memcmp(c.p, "true", 4) == 0) {
      c.p += 4;
      return true;
    }
  } else if (ch == 'f') {
    if (c.e - c.p >= 5 && std::memcmp(c.p, "false", 5) == 0) {
      c.p += 5;
      return true;
    }
  } else if (ch == 'n') {
    if (c.e - c.p >= 4 && std::memcmp(c.p, "null", 4) == 0) {
      c.p += 4;
      return true;
    }
  } else if (ch == '-' || (ch >= '0' && ch <= '9')) {
    long v;
    bool isnum;
    int_token(c, &v, &isnum);
    // Valid floats/overflows skip fine (is_number, not c.bad); grammar
    // violations keep c.bad so the frame falls back whole.
    return !c.bad;
  }
  c.bad = true;
  return false;
}

inline bool key_is(const P& c, const Span& k, const char* name) {
  const long n = static_cast<long>(std::strlen(name));
  return k.len() == n && std::memcmp(c.s + k.a, name, n) == 0;
}

// Materialize a (possibly escaped) inner string span as std::string.
bool span_str(const P& c, const Span& sp, bool esc, std::string* out) {
  if (!esc) {
    // Whole buffers are UTF-8-gated up front (parse_boxcar) and UTF-8
    // is self-synchronizing across the ASCII quote boundaries, so a
    // raw span cannot be invalid — no per-span rescan on the hot path.
    out->assign(c.s + sp.a, sp.len());
    return true;
  }
  long chars = 0;
  out->clear();
  if (!unescape(c.s + sp.a, c.s + sp.b, out, &chars)) return false;
  return utf8_valid(out->data(), out->data() + out->size());
}

// ---------------------------------------------------------------------------
// op-object field collection (order-independent single pass)
// ---------------------------------------------------------------------------

struct OpFields {
  bool clean = true;       // no anomalies seen
  bool type_is_int = false, type_is_str = false;
  long type_i = -1;
  Span type_s;
  bool type_esc = false;
  bool has_pos1 = false, has_pos2 = false, has_delta = false;
  long pos1 = 0, pos2 = 0, delta = 0;
  bool has_seg = false, seg_text_present = false, seg_marker = false;
  bool seg_other = false;  // unknown payload keys / non-literal marker
  //                            values -> unmodelable (items/runs are
  //                            modelable via their own flags)
  Span seg_text;
  bool seg_text_esc = false;
  Span seg_props;  // raw JSON span of seg.props
  Span props;      // raw JSON span of op.props (annotate)
  bool has_key = false;
  Span key;
  bool key_esc = false;
  bool has_value = false;
  Span value;  // raw JSON span of op.value
  bool has_pid = false;
  bool has_ops = false;  // group op
  // SharedDirectory envelope: {"type":"storage","path":...,"op":{...}}
  bool has_path = false;
  Span path;
  bool path_esc = false;
  // SharedMatrix envelope (dds/matrix.py): {"target": ..., "op"|"key"/...}
  int mx = 0;                  // 0 none, 1 rows, 2 cols, 3 cell
  bool has_inner = false;      // "op": {...} parsed into *inner
  bool seg_run = false;        // seg carried a "run" id-span array
  Span seg_run_span;           // raw span (validated by parse_run_array)
  bool seg_items = false;      // seg carried an "items" value array
  Span seg_items_span;         // raw span of the array
  long seg_items_count = -1;   // element count (device new_len)
};

bool raw_span(P& c, Span* out) {
  ws(c);
  out->a = static_cast<int32_t>(c.p - c.s);
  if (!skip_value(c)) return false;
  out->b = static_cast<int32_t>(c.p - c.s);
  return true;
}

// Validate a matrix run payload span "[nonce, counter, start, length]"
// (mergetree/runs.py Run.encode) and extract the length. The first two
// elements may exceed int32 (48-bit nonce) — they stay in the raw span for
// Python-side decoding; only the length must fit the device column.
bool parse_run_array(const char* a, const char* b, long* len_out) {
  P rc{a, a, b};
  ws(rc);
  if (!peek(rc, '[')) return false;
  ++rc.p;
  long vals[4];
  for (int i = 0; i < 4; ++i) {
    bool isnum;
    if (!int_token(rc, &vals[i], &isnum)) return false;
    if (i < 3) {
      if (!eat(rc, ',')) return false;
    }
  }
  if (!eat(rc, ']')) return false;
  ws(rc);
  if (rc.p != rc.e) return false;
  *len_out = vals[3];
  return vals[3] > 0;
}

bool parse_seg(P& c, OpFields* f) {
  ws(c);
  if (!peek(c, '{')) {
    f->seg_other = true;
    return skip_value(c);
  }
  ++c.p;
  if (eat(c, '}')) return true;
  while (true) {
    Span k;
    bool esc;
    if (!str_token(c, &k, &esc) || !eat(c, ':')) {
      c.bad = true;
      return false;
    }
    if (key_is(c, k, "run")) {
      if (!raw_span(c, &f->seg_run_span)) return false;
      f->seg_run = true;
    } else if (key_is(c, k, "items")) {
      ws(c);
      if (!peek(c, '[')) {
        f->seg_other = true;  // non-array items: unmodelable
        if (!skip_value(c)) return false;
      } else {
        if (!raw_span(c, &f->seg_items_span)) return false;
        // Count top-level elements (device new_len) on a sub-cursor.
        P ic{c.s, c.s + f->seg_items_span.a, c.s + f->seg_items_span.b};
        long count = 0;
        if (!eat(ic, '[')) return false;
        if (!eat(ic, ']')) {
          while (true) {
            if (!skip_value(ic)) {
              f->seg_other = true;  // malformed array: slow path
              break;
            }
            ++count;
            if (eat(ic, ',')) continue;
            if (eat(ic, ']')) break;
            f->seg_other = true;
            break;
          }
        }
        if (!f->seg_other && count > 0) {
          f->seg_items = true;
          f->seg_items_count = count;
        } else if (count == 0) {
          f->seg_other = true;  // empty items insert: slow path decides
        }
      }
    } else if (key_is(c, k, "text")) {
      if (!peek(c, '"')) {
        f->seg_other = true;  // non-string text (items ride "items" anyway)
        if (!skip_value(c)) return false;
      } else {
        if (!str_token(c, &f->seg_text, &f->seg_text_esc)) return false;
        f->seg_text_present = true;
      }
    } else if (key_is(c, k, "marker")) {
      // The slow path tests truthiness (seg.get("marker")); the pump
      // can only evaluate the JSON literals. true/false/null map
      // exactly; any other value (1, "x", [...]) falls back so the two
      // paths can never diverge on what counts as a marker.
      ws(c);
      char m0 = (c.p < c.e) ? *c.p : '\0';
      if (m0 == 't') {
        f->seg_marker = true;
      } else if (m0 != 'f' && m0 != 'n') {
        f->seg_other = true;  // non-literal marker value: unmodelable
      }
      if (!skip_value(c)) return false;
    } else if (key_is(c, k, "props")) {
      if (!raw_span(c, &f->seg_props)) return false;
    } else {
      f->seg_other = true;  // unknown payload key: unmodelable
      if (!skip_value(c)) return false;
    }
    if (eat(c, ',')) continue;
    if (eat(c, '}')) return true;
    c.bad = true;
    return false;
  }
}

bool parse_op_object(P& c, OpFields* f, OpFields* inner = nullptr) {
  ws(c);
  if (!peek(c, '{')) return skip_value(c);  // non-dict op: family none
  ++c.p;
  if (eat(c, '}')) return true;
  while (true) {
    Span k;
    bool esc;
    if (!str_token(c, &k, &esc) || !eat(c, ':')) {
      c.bad = true;
      return false;
    }
    if (key_is(c, k, "path")) {
      ws(c);
      if (peek(c, '"')) {
        if (!str_token(c, &f->path, &f->path_esc)) return false;
        f->has_path = true;
      } else {
        if (!skip_value(c)) return false;
      }
    } else if (key_is(c, k, "target")) {
      // SharedMatrix envelope discriminator (dds/matrix.py).
      ws(c);
      if (peek(c, '"')) {
        Span sp;
        bool e2;
        if (!str_token(c, &sp, &e2)) return false;
        std::string t;
        if (span_str(c, sp, e2, &t)) {
          if (t == "rows") f->mx = 1;
          else if (t == "cols") f->mx = 2;
          else if (t == "cell") f->mx = 3;
        }
      } else {
        if (!skip_value(c)) return false;
      }
    } else if (key_is(c, k, "op") && inner != nullptr) {
      ws(c);
      if (peek(c, '{')) {
        f->has_inner = true;
        if (!parse_op_object(c, inner)) return false;  // depth 1 only
      } else {
        if (!skip_value(c)) return false;
      }
    } else if (key_is(c, k, "type")) {
      ws(c);
      if (peek(c, '"')) {
        if (!str_token(c, &f->type_s, &f->type_esc)) return false;
        f->type_is_str = true;
      } else {
        bool isnum;
        if (int_token(c, &f->type_i, &isnum)) {
          f->type_is_int = true;
        } else {
          if (c.bad) return false;
          f->clean = false;  // float/huge type
        }
      }
    } else if (key_is(c, k, "pos1")) {
      bool isnum;
      if (int_token(c, &f->pos1, &isnum)) f->has_pos1 = true;
      else {
        if (c.bad) return false;
        f->clean = false;
      }
    } else if (key_is(c, k, "pos2")) {
      bool isnum;
      if (int_token(c, &f->pos2, &isnum)) f->has_pos2 = true;
      else {
        if (c.bad) return false;
        f->clean = false;
      }
    } else if (key_is(c, k, "delta")) {
      bool isnum;
      if (int_token(c, &f->delta, &isnum)) f->has_delta = true;
      else {
        if (c.bad) return false;
        f->clean = false;
      }
    } else if (key_is(c, k, "seg")) {
      f->has_seg = true;
      if (!parse_seg(c, f)) return false;
    } else if (key_is(c, k, "props")) {
      if (!raw_span(c, &f->props)) return false;
    } else if (key_is(c, k, "key")) {
      if (peek(c, '"')) {
        if (!str_token(c, &f->key, &f->key_esc)) return false;
        f->has_key = true;
      } else {
        if (!skip_value(c)) return false;
      }
    } else if (key_is(c, k, "value")) {
      f->has_value = true;
      if (!raw_span(c, &f->value)) return false;
    } else if (key_is(c, k, "pid")) {
      f->has_pid = true;
      if (!skip_value(c)) return false;
    } else if (key_is(c, k, "ops")) {
      f->has_ops = true;
      if (!skip_value(c)) return false;
    } else {
      if (!skip_value(c)) return false;
    }
    if (eat(c, ',')) continue;
    if (eat(c, '}')) return true;
    c.bad = true;
    return false;
  }
}

// ---------------------------------------------------------------------------
// interning
// ---------------------------------------------------------------------------

// Hand an intern delta tuple to the Python mirror. Returns false on ANY
// failure (allocation or append) with the pending exception cleared —
// the caller must then UNDO its C-side intern and signal frame fallback,
// or the two intern tables would silently diverge.
bool push_delta(PyObject* list, PyObject* t) {
  if (t == nullptr) {
    PyErr_Clear();
    return false;
  }
  int rc = PyList_Append(list, t);
  Py_DECREF(t);
  if (rc != 0) {
    PyErr_Clear();
    return false;
  }
  return true;
}

int32_t intern_doc(Ctx* ctx, const std::string& name) {
  auto it = ctx->docs.find(name);
  if (it != ctx->docs.end()) return it->second;
  int32_t ord = static_cast<int32_t>(ctx->docs.size());
  ctx->docs.emplace(name, ord);
  ctx->doc_clients.emplace_back();
  ctx->doc_next_ord.push_back(0);
  if (!push_delta(ctx->new_docs,
                  Py_BuildValue("(is)", ord, name.c_str()))) {
    ctx->docs.erase(name);
    ctx->doc_clients.pop_back();
    ctx->doc_next_ord.pop_back();
    return -1;  // caller falls the frame back
  }
  return ord;
}

int32_t intern_client(Ctx* ctx, int32_t doc, const std::string& cid) {
  auto& m = ctx->doc_clients[doc];
  auto it = m.find(cid);
  if (it != m.end()) return it->second;
  int32_t ord = ctx->doc_next_ord[doc]++;
  m.emplace(cid, ord);
  if (!push_delta(ctx->new_clients,
                  Py_BuildValue("(iis)", doc, ord, cid.c_str()))) {
    m.erase(cid);
    --ctx->doc_next_ord[doc];
    return -1;  // caller falls the frame back
  }
  return ord;
}

int32_t intern_channel(Ctx* ctx, int32_t doc, const std::string& store,
                       const std::string& chan) {
  std::string key = std::to_string(doc);
  key.push_back('\x1f');
  key += store;
  key.push_back('\x1f');
  key += chan;
  auto it = ctx->channels.find(key);
  if (it != ctx->channels.end()) return it->second;
  int32_t ord = static_cast<int32_t>(ctx->channels.size());
  ctx->channels.emplace(key, ord);  // no move: erase(key) on failure
  // s# (length-explicit): matrix sub-lane names carry an embedded NUL
  // ("chan\0mx:rows"), which plain "s" would silently truncate.
  if (!push_delta(ctx->new_channels,
                  Py_BuildValue("(iiss#)", ord, doc, store.c_str(),
                                chan.data(),
                                static_cast<Py_ssize_t>(chan.size())))) {
    ctx->channels.erase(key);
    return -1;  // caller falls the frame back
  }
  return ord;
}

int32_t intern_lww_key(Ctx* ctx, const std::string& k) {
  auto it = ctx->lww_keys.find(k);
  if (it != ctx->lww_keys.end()) return it->second;
  int32_t ord = static_cast<int32_t>(ctx->lww_keys.size());
  ctx->lww_keys.emplace(k, ord);
  // s#: the reserved cell key "\0cell" has an embedded NUL.
  if (!push_delta(ctx->new_keys,
                  Py_BuildValue("(is#)", ord, k.data(),
                                static_cast<Py_ssize_t>(k.size())))) {
    ctx->lww_keys.erase(k);
    return -1;  // caller falls the frame back
  }
  return ord;
}

// ---------------------------------------------------------------------------
// message + boxcar parsing
// ---------------------------------------------------------------------------

struct Row {
  int32_t v[NF];
  Row() {
    for (int i = 0; i < NF; ++i) v[i] = -1;
    v[C_KIND] = K_NOOP;
    v[C_FAMILY] = FAM_NONE;
    v[C_FLAGS] = 0;
    v[C_CSEQ] = 0;
    v[C_REFSEQ] = 0;
    v[C_POS1] = 0;
    v[C_POS2] = 0;
    v[C_TEXTLEN] = 0;
    v[C_CHARLEN] = 0;
  }
};

void push_row(Ctx* ctx, const Row& r) {
  for (int i = 0; i < NF; ++i) ctx->cols[i].push_back(r.v[i]);
}

inline bool fits32(long v) { return v >= kInt32Min && v <= kInt32Max; }

// "\x00cell" — SharedCell's reserved LWW key (server/tpu_sequencer.py).
const std::string kCellKey(std::string("\0cell", 5));

// Per-boxcar channel-intern memo: a boxcar's ops overwhelmingly target
// one channel, and the full intern (key build + hash probe) per op was
// the parse hot spot.
struct ChanMemo {
  std::string store, chan;
  int32_t ord = -1;
};

// Parse the merge/lww op envelope inside msg.contents:
//   {"address": store, "contents": {"address": chan, "contents": OP}}
// Fills the row's family/channel/op columns; leaves family NONE for shapes
// the materializer ignores (matching the Python slow path's early returns).
bool parse_envelope(Ctx* ctx, P& c, int32_t doc, Row* r, ChanMemo* memo) {
  ws(c);
  if (!peek(c, '{')) return skip_value(c);  // non-dict contents: none
  ++c.p;
  if (eat(c, '}')) return true;
  std::string store, chan;
  bool have_store = false, have_chan = false;
  bool have_op = false;
  OpFields f;
  OpFields fi;  // matrix inner axis op ({"target": ..., "op": {...}})
  while (true) {
    Span k;
    bool esc;
    if (!str_token(c, &k, &esc) || !eat(c, ':')) {
      c.bad = true;
      return false;
    }
    if (key_is(c, k, "address")) {
      Span sp;
      bool sesc;
      if (!peek(c, '"')) {
        if (!skip_value(c)) return false;
      } else {
        if (!str_token(c, &sp, &sesc)) return false;
        if (!span_str(c, sp, sesc, &store)) {
          c.bad = true;
          return false;
        }
        have_store = true;
      }
    } else if (key_is(c, k, "contents")) {
      // inner envelope
      ws(c);
      if (!peek(c, '{')) {
        if (!skip_value(c)) return false;
      } else {
        ++c.p;
        if (eat(c, '}')) { /* empty */ }
        else {
          while (true) {
            Span k2;
            bool esc2;
            if (!str_token(c, &k2, &esc2) || !eat(c, ':')) {
              c.bad = true;
              return false;
            }
            if (key_is(c, k2, "address")) {
              Span sp;
              bool sesc;
              if (!peek(c, '"')) {
                if (!skip_value(c)) return false;
              } else {
                if (!str_token(c, &sp, &sesc)) return false;
                if (!span_str(c, sp, sesc, &chan)) {
                  c.bad = true;
                  return false;
                }
                have_chan = true;
              }
            } else if (key_is(c, k2, "contents")) {
              have_op = true;
              if (!parse_op_object(c, &f, &fi)) return false;
            } else {
              if (!skip_value(c)) return false;
            }
            if (eat(c, ',')) continue;
            if (eat(c, '}')) break;
            c.bad = true;
            return false;
          }
        }
      }
    } else {
      if (!skip_value(c)) return false;
    }
    if (eat(c, ',')) continue;
    if (eat(c, '}')) break;
    c.bad = true;
    return false;
  }

  auto memo_chan = [&]() -> int32_t {
    if (memo->ord >= 0 && memo->store == store && memo->chan == chan)
      return memo->ord;
    int32_t o = intern_channel(ctx, doc, store, chan);
    memo->store = store;
    memo->chan = chan;
    memo->ord = o;
    return o;
  };

  if (!have_store || !have_chan || !have_op) return true;  // family none

  // SharedMatrix envelope (tpu_sequencer.matrix_route): axis ops become
  // merge rows on suffixed channels, cell writes LWW rows on the cells
  // channel. Shapes outside the dds/matrix.py submit set FALL BACK.
  if (f.mx != 0) {
    static const std::string kRowsSuffix("\0mx:rows", 8);
    static const std::string kColsSuffix("\0mx:cols", 8);
    static const std::string kCellsSuffix("\0mx:cells", 9);
    if (f.mx == 3) {  // cell write
      if (!f.has_key) return true;  // not a matrix cell shape: none
      std::string key;
      if (!span_str(c, f.key, f.key_esc, &key)) return true;
      r->v[C_FAMILY] = FAM_LWW;
      r->v[C_CHAN] = intern_channel(ctx, doc, store, chan + kCellsSuffix);
      r->v[C_MKIND] = LW_SET;
      r->v[C_POS1] = intern_lww_key(ctx, key);
      if (f.has_value) {
        r->v[C_FLAGS] |= F_VALUE;
        r->v[C_PSTART] = f.value.a;
        r->v[C_PEND] = f.value.b;
      }
      return true;
    }
    if (!f.has_inner || !fi.clean || !fi.type_is_int || !fi.has_pos1 ||
        !fits32(fi.pos1) || !fits32(fi.pos2)) {
      r->v[C_FLAGS] |= F_FALLBACK;
      return true;
    }
    const std::string& suffix = (f.mx == 1) ? kRowsSuffix : kColsSuffix;
    if (fi.type_i == 0 && fi.has_seg && fi.seg_run && !fi.seg_other &&
        !fi.seg_text_present && !fi.seg_marker) {
      long run_len = -1;
      if (!parse_run_array(c.s + fi.seg_run_span.a,
                           c.s + fi.seg_run_span.b, &run_len) ||
          !fits32(run_len)) {
        r->v[C_FLAGS] |= F_FALLBACK;
        return true;
      }
      r->v[C_FAMILY] = FAM_MERGE;
      r->v[C_CHAN] = intern_channel(ctx, doc, store, chan + suffix);
      r->v[C_MKIND] = M_INSERT;
      r->v[C_FLAGS] |= F_RUN;
      r->v[C_POS1] = static_cast<int32_t>(fi.pos1);
      r->v[C_CHARLEN] = static_cast<int32_t>(run_len);
      r->v[C_PSTART] = fi.seg_run_span.a;
      r->v[C_PEND] = fi.seg_run_span.b;
      return true;
    }
    if (fi.type_i == 1 && fi.has_pos2) {
      r->v[C_FAMILY] = FAM_MERGE;
      r->v[C_CHAN] = intern_channel(ctx, doc, store, chan + suffix);
      r->v[C_MKIND] = M_REMOVE;
      r->v[C_POS1] = static_cast<int32_t>(fi.pos1);
      r->v[C_POS2] = static_cast<int32_t>(fi.pos2);
      return true;
    }
    // axis annotate / text insert / group: not a dds/matrix shape
    r->v[C_FLAGS] |= F_FALLBACK;
    return true;
  }

  // Classification mirrors catchup.looks_like_merge_op /
  // tpu_sequencer.looks_like_lww_op exactly; merge-looking shapes the
  // kernel cannot model FALL BACK (the slow path drops the lane — that
  // behavior must be preserved, not skipped).
  if (f.has_ops && f.type_is_int && f.type_i == 3) {
    r->v[C_FLAGS] |= F_FALLBACK;  // group op: rare, slow path handles
    return true;
  }
  if (f.type_is_int && f.has_pos1 && f.type_i >= 0 && f.type_i <= 2) {
    if (!f.clean || !fits32(f.pos1) || !fits32(f.pos2)) {
      r->v[C_FLAGS] |= F_FALLBACK;
      return true;
    }
    r->v[C_CHAN] = memo_chan();
    if (f.type_i == 0) {  // insert
      if (f.has_seg && f.seg_marker && !f.seg_other) {
        r->v[C_FAMILY] = FAM_MERGE;
        r->v[C_MKIND] = M_INSERT;
        r->v[C_FLAGS] |= F_MARKER;
        r->v[C_POS1] = static_cast<int32_t>(f.pos1);
        r->v[C_CHARLEN] = 1;
        if (f.seg_props.present()) {
          r->v[C_FLAGS] |= F_PROPS;
          r->v[C_PSTART] = f.seg_props.a;
          r->v[C_PEND] = f.seg_props.b;
        }
        return true;
      }
      if (f.has_seg && f.seg_text_present && !f.seg_other) {
        long off = static_cast<long>(ctx->arena.size());
        long chars = 0;
        if (f.seg_text_esc) {
          if (!unescape(c.s + f.seg_text.a, c.s + f.seg_text.b, &ctx->arena,
                        &chars)) {
            ctx->arena.resize(off);
            r->v[C_FLAGS] |= F_FALLBACK;
            return true;
          }
        } else {
          ctx->arena.append(c.s + f.seg_text.a, f.seg_text.len());
          for (long i = f.seg_text.a; i < f.seg_text.b; ++i)
            if ((static_cast<uint8_t>(c.s[i]) & 0xC0) != 0x80) ++chars;
        }
        long blen = static_cast<long>(ctx->arena.size()) - off;
        if (!fits32(off) || !fits32(chars)) {
          r->v[C_FLAGS] |= F_FALLBACK;
          return true;
        }
        r->v[C_FAMILY] = FAM_MERGE;
        r->v[C_MKIND] = M_INSERT;
        r->v[C_POS1] = static_cast<int32_t>(f.pos1);
        r->v[C_TEXTOFF] = static_cast<int32_t>(off);
        r->v[C_TEXTLEN] = static_cast<int32_t>(blen);
        r->v[C_CHARLEN] = static_cast<int32_t>(chars);
        if (f.seg_props.present()) {
          r->v[C_FLAGS] |= F_PROPS;
          r->v[C_PSTART] = f.seg_props.a;
          r->v[C_PEND] = f.seg_props.b;
        }
        return true;
      }
      if (f.has_seg && f.seg_items && !f.seg_other &&
          !f.seg_text_present && !f.seg_marker &&
          !f.seg_props.present() && fits32(f.seg_items_count)) {
        // Item-sequence insert (round 5: items materialize on server
        // lanes). PSTART/PEND carry the value-array span; props-bearing
        // items inserts keep the slow path (the one span is taken).
        r->v[C_FAMILY] = FAM_MERGE;
        r->v[C_MKIND] = M_INSERT;
        r->v[C_FLAGS] |= F_ITEMS;
        r->v[C_POS1] = static_cast<int32_t>(f.pos1);
        r->v[C_CHARLEN] = static_cast<int32_t>(f.seg_items_count);
        r->v[C_PSTART] = f.seg_items_span.a;
        r->v[C_PEND] = f.seg_items_span.b;
        return true;
      }
      // merge-looking insert the kernel cannot model (no payload)
      r->v[C_FLAGS] |= F_FALLBACK;
      return true;
    }
    if (f.type_i == 1) {  // remove
      if (!f.has_pos2) {
        r->v[C_FLAGS] |= F_FALLBACK;
        return true;
      }
      r->v[C_FAMILY] = FAM_MERGE;
      r->v[C_MKIND] = M_REMOVE;
      r->v[C_POS1] = static_cast<int32_t>(f.pos1);
      r->v[C_POS2] = static_cast<int32_t>(f.pos2);
      return true;
    }
    // annotate
    if (!f.has_pos2) {
      r->v[C_FLAGS] |= F_FALLBACK;
      return true;
    }
    r->v[C_FAMILY] = FAM_MERGE;
    r->v[C_MKIND] = M_ANNOTATE;
    r->v[C_POS1] = static_cast<int32_t>(f.pos1);
    r->v[C_POS2] = static_cast<int32_t>(f.pos2);
    if (f.props.present()) {
      r->v[C_FLAGS] |= F_PROPS;
      r->v[C_PSTART] = f.props.a;
      r->v[C_PEND] = f.props.b;
    }
    return true;
  }

  if (f.type_is_str) {
    std::string t;
    if (!span_str(c, f.type_s, f.type_esc, &t)) return true;
    // SharedDirectory envelope (tpu_sequencer.directory_route): ROOT
    // set/delete ride the LWW lane directly ("/" always exists, so the
    // host path-existence gate is trivially satisfied); pathed ops,
    // clears (expand to per-key deletes), and structural ops need the
    // slow path's host structure tracking.
    if (t == "storage" || t == "createSubDirectory" ||
        t == "deleteSubDirectory") {
      if (t == "storage" && f.has_path && f.has_inner) {
        std::string path;
        if (!span_str(c, f.path, f.path_esc, &path)) return true;
        std::string it;
        bool inner_str = fi.type_is_str &&
            span_str(c, fi.type_s, fi.type_esc, &it);
        if (path == "/" && inner_str && (it == "set" || it == "delete") &&
            fi.has_key && fi.has_pid) {
          std::string key;
          if (!span_str(c, fi.key, fi.key_esc, &key)) return true;
          static const std::string kDirSuffix("\0dir", 4);
          r->v[C_FAMILY] = FAM_LWW;
          r->v[C_CHAN] = intern_channel(ctx, doc, store, chan + kDirSuffix);
          r->v[C_MKIND] = (it == "set") ? LW_SET : LW_DELETE;
          r->v[C_POS1] = intern_lww_key(ctx, "/\x1e" + key);
          if (it == "set" && fi.has_value) {
            r->v[C_FLAGS] |= F_VALUE;
            r->v[C_PSTART] = fi.value.a;
            r->v[C_PEND] = fi.value.b;
          }
          return true;
        }
      }
      r->v[C_FLAGS] |= F_FALLBACK;
      return true;
    }
    auto lww_common = [&](int kind, int32_t key_ord) {
      r->v[C_FAMILY] = FAM_LWW;
      r->v[C_CHAN] = memo_chan();
      r->v[C_MKIND] = kind;
      r->v[C_POS1] = key_ord;
    };
    if ((t == "set" || t == "delete") && f.has_key && f.has_pid) {
      std::string key;
      if (!span_str(c, f.key, f.key_esc, &key)) return true;
      lww_common(t == "set" ? LW_SET : LW_DELETE, intern_lww_key(ctx, key));
      if (t == "set") {
        if (f.has_value) {
          r->v[C_FLAGS] |= F_VALUE;
          r->v[C_PSTART] = f.value.a;
          r->v[C_PEND] = f.value.b;
        }
      }
      return true;
    }
    if (t == "clear" && f.has_pid) {
      lww_common(LW_CLEAR, -1);
      return true;
    }
    if (t == "increment" && f.has_delta) {
      if (!fits32(f.delta)) return true;  // slow path: silent skip
      lww_common(LW_ADD, -1);
      r->v[C_POS2] = static_cast<int32_t>(f.delta);
      return true;
    }
    if (t == "setCell" || t == "deleteCell") {
      lww_common(t == "setCell" ? LW_SET : LW_DELETE,
                 intern_lww_key(ctx, kCellKey));
      if (t == "setCell" && f.has_value) {
        r->v[C_FLAGS] |= F_VALUE;
        r->v[C_PSTART] = f.value.a;
        r->v[C_PEND] = f.value.b;
      }
      return true;
    }
  }
  return true;  // unknown op: family none (ticket + emit only)
}

// Extract "clientId" from a join/leave data payload (a JSON string whose
// CONTENT is JSON). Returns false when absent/malformed.
bool client_from_data(const P& c, const Span& data_inner, bool esc,
                      std::string* out) {
  std::string inner;
  if (!span_str(c, data_inner, esc, &inner)) return false;
  P ic{inner.data(), inner.data(), inner.data() + inner.size()};
  ws(ic);
  if (!peek(ic, '{')) {
    // leave data may be a bare JSON string: the leaving client id
    if (peek(ic, '"')) {
      Span sp;
      bool e2;
      if (!str_token(ic, &sp, &e2)) return false;
      return span_str(ic, sp, e2, out);
    }
    return false;
  }
  ++ic.p;
  if (eat(ic, '}')) return false;
  while (true) {
    Span k;
    bool esc2;
    if (!str_token(ic, &k, &esc2) || !eat(ic, ':')) return false;
    if (key_is(ic, k, "clientId")) {
      if (!peek(ic, '"')) return false;
      Span sp;
      bool e3;
      if (!str_token(ic, &sp, &e3)) return false;
      return span_str(ic, sp, e3, out);
    }
    if (!skip_value(ic)) return false;
    if (eat(ic, ',')) continue;
    if (eat(ic, '}')) return false;
    return false;
  }
}

// One message object. On any anomaly: rewind, record a fallback row
// spanning the whole message, and skip it structurally.
bool parse_message(Ctx* ctx, P& c, int32_t buf_idx, int32_t doc,
                   int32_t sender_ord, bool has_sender,
                   const std::string& sender_id, ChanMemo* memo) {
  ws(c);
  const char* msg_start = c.p;
  Row r;
  r.v[C_DOC] = doc;
  r.v[C_BUF] = buf_idx;
  r.v[C_MSTART] = static_cast<int32_t>(msg_start - c.s);

  bool fallback = false;
  long cseq = 0, rseq = 0;
  bool have_cseq = false, have_rseq = false;
  std::string mtype;
  bool have_type = false;
  Span data_sp;
  bool data_esc = false, have_data = false;
  bool contents_seen = false;
  bool contents_parsed = false;

  if (!peek(c, '{')) {
    c.bad = true;
    return false;
  }
  ++c.p;
  bool done = eat(c, '}');
  while (!done) {
    Span k;
    bool esc;
    if (!str_token(c, &k, &esc) || !eat(c, ':')) {
      c.bad = true;
      return false;
    }
    if (key_is(c, k, "client_sequence_number")) {
      bool isnum;
      if (int_token(c, &cseq, &isnum) && fits32(cseq)) have_cseq = true;
      else {
        if (c.bad) return false;
        fallback = true;
      }
    } else if (key_is(c, k, "reference_sequence_number")) {
      bool isnum;
      if (int_token(c, &rseq, &isnum) && fits32(rseq)) have_rseq = true;
      else {
        if (c.bad) return false;
        fallback = true;
      }
    } else if (key_is(c, k, "type")) {
      Span sp;
      bool tesc;
      if (!peek(c, '"')) {
        fallback = true;
        if (!skip_value(c)) return false;
      } else {
        if (!str_token(c, &sp, &tesc)) return false;
        if (!span_str(c, sp, tesc, &mtype)) {
          c.bad = true;
          return false;
        }
        have_type = true;
      }
    } else if (key_is(c, k, "contents")) {
      contents_seen = true;
      if (have_type && mtype == "op" && has_sender) {
        contents_parsed = true;
        if (!parse_envelope(ctx, c, doc, &r, memo)) return false;
      } else {
        // type unknown yet (serializer order guarantees type first) or a
        // non-op message: raw skip; lazy materialization reads the span.
        if (!skip_value(c)) return false;
        if (!have_type) fallback = true;  // foreign field order
      }
    } else if (key_is(c, k, "data")) {
      ws(c);
      if (peek(c, '"')) {
        if (!str_token(c, &data_sp, &data_esc)) return false;
        have_data = true;
      } else {
        if (!skip_value(c)) return false;
      }
    } else {
      if (!skip_value(c)) return false;  // metadata/server_metadata/traces
    }
    if (eat(c, ',')) continue;
    if (eat(c, '}')) break;
    c.bad = true;
    return false;
  }
  r.v[C_MEND] = static_cast<int32_t>(c.p - c.s);
  (void)contents_seen;

  if (!have_type) fallback = true;
  if (!fallback) {
    if (mtype == "join") {
      std::string joining = sender_id;
      bool okj = has_sender;
      if (have_data) {
        std::string from_data;
        if (client_from_data(c, data_sp, data_esc, &from_data)) {
          joining = from_data;
          okj = true;
        }
      }
      if (!okj) fallback = true;
      else {
        r.v[C_KIND] = K_JOIN;
        r.v[C_CLIENT] = intern_client(ctx, doc, joining);
      }
    } else if (mtype == "leave") {
      fallback = true;  // window-cut + NoClient semantics: slow path
    } else if (!has_sender) {
      r.v[C_KIND] = K_SYSTEM;
      r.v[C_CLIENT] = -1;
    } else {
      if (!have_cseq || !have_rseq) fallback = true;
      else {
        r.v[C_KIND] = K_OP;
        r.v[C_CLIENT] = sender_ord;
        r.v[C_CSEQ] = static_cast<int32_t>(cseq);
        r.v[C_REFSEQ] = static_cast<int32_t>(rseq);
        if (mtype != "op") {
          // summarize/propose/chunked/etc.: ticket + emit, no
          // materialization — family stays NONE.
          r.v[C_FAMILY] = FAM_NONE;
          r.v[C_CHAN] = -1;
        } else if (!contents_parsed) {
          r.v[C_FAMILY] = FAM_NONE;
        }
      }
    }
  }
  if (fallback) {
    r.v[C_FLAGS] |= F_FALLBACK;
    r.v[C_FAMILY] = FAM_NONE;
    r.v[C_CHAN] = -1;
  }
  // Centralized intern-failure guard: a classified row whose channel
  // (or a SET/DELETE key) intern failed must fall back rather than ride
  // with a divergent ordinal (push_delta cleared the error; the Python
  // mirror never saw the mapping).
  if (r.v[C_FAMILY] != FAM_NONE && r.v[C_CHAN] < 0) {
    r.v[C_FLAGS] |= F_FALLBACK;
    r.v[C_FAMILY] = FAM_NONE;
  }
  if (r.v[C_FAMILY] == FAM_LWW &&
      (r.v[C_MKIND] == LW_SET || r.v[C_MKIND] == LW_DELETE) &&
      r.v[C_POS1] < 0) {
    r.v[C_FLAGS] |= F_FALLBACK;
    r.v[C_FAMILY] = FAM_NONE;
  }
  push_row(ctx, r);
  return true;
}

// One boxcar buffer. On structural failure, emit a single whole-buffer
// fallback row (DOC -1: Python routes by the queue key).
void parse_boxcar(Ctx* ctx, int32_t buf_idx, const char* s, Py_ssize_t n) {
  P c{s, s, s + n};
  size_t row_mark[NF];
  for (int i = 0; i < NF; ++i) row_mark[i] = ctx->cols[i].size();
  size_t arena_mark = ctx->arena.size();

  auto fail = [&]() {
    for (int i = 0; i < NF; ++i) ctx->cols[i].resize(row_mark[i]);
    ctx->arena.resize(arena_mark);
    Row r;
    r.v[C_BUF] = buf_idx;
    r.v[C_MSTART] = 0;
    r.v[C_MEND] = static_cast<int32_t>(n);
    r.v[C_FLAGS] = F_FALLBACK;
    push_row(ctx, r);
  };

  // Whole-buffer UTF-8 gate: arena text, interned names, lww value
  // spans, and emit-time message spans all decode into Python strings
  // later; one invalid byte anywhere must cost THIS frame (fallback →
  // slow-path poison drop), never a deferred UnicodeDecodeError.
  if (!utf8_valid(s, s + n)) return fail();

  if (!eat(c, '{')) return fail();
  std::string doc_id, client_id;
  bool have_doc = false, have_client = false, client_null = false;
  bool saw_contents = false;
  bool done = eat(c, '}');
  while (!done) {
    Span k;
    bool esc;
    if (!str_token(c, &k, &esc) || !eat(c, ':')) return fail();
    if (key_is(c, k, "documentId")) {
      Span sp;
      bool desc;
      if (!peek(c, '"')) return fail();
      if (!str_token(c, &sp, &desc)) return fail();
      if (!span_str(c, sp, desc, &doc_id)) return fail();
      have_doc = true;
    } else if (key_is(c, k, "clientId")) {
      ws(c);
      if (peek(c, '"')) {
        Span sp;
        bool cesc;
        if (!str_token(c, &sp, &cesc)) return fail();
        if (!span_str(c, sp, cesc, &client_id)) return fail();
        have_client = true;
      } else {
        client_null = true;
        if (!skip_value(c)) return fail();
      }
    } else if (key_is(c, k, "contents")) {
      if (!have_doc || (!have_client && !client_null)) {
        // Foreign key order: we need doc + sender before the messages.
        return fail();
      }
      saw_contents = true;
      ChanMemo memo;
      int32_t doc = intern_doc(ctx, doc_id);
      if (doc < 0) return fail();
      int32_t sender_ord = -1;
      if (have_client) {
        sender_ord = intern_client(ctx, doc, client_id);
        if (sender_ord < 0) return fail();
      }
      ws(c);
      if (!eat(c, '[')) return fail();
      if (!eat(c, ']')) {
        while (true) {
          if (!parse_message(ctx, c, buf_idx, doc, sender_ord, have_client,
                             client_id, &memo))
            return fail();
          if (eat(c, ',')) continue;
          if (eat(c, ']')) break;
          return fail();
        }
      }
    } else {
      if (!skip_value(c)) return fail();
    }
    if (eat(c, ',')) continue;
    if (eat(c, '}')) break;
    return fail();
  }
  if (!saw_contents || c.bad) return fail();
}

}  // namespace

// ---------------------------------------------------------------------------
// exported API (ctypes.PyDLL)
// ---------------------------------------------------------------------------

extern "C" {

void* pump_new() {
  Ctx* ctx = new Ctx();
  clear_outputs(ctx);
  return ctx;
}

void pump_free(void* p) {
  Ctx* ctx = static_cast<Ctx*>(p);
  Py_CLEAR(ctx->new_docs);
  Py_CLEAR(ctx->new_clients);
  Py_CLEAR(ctx->new_channels);
  Py_CLEAR(ctx->new_keys);
  delete ctx;
}

// Parse a list of boxcar byte buffers; returns the row count (>= 0) or a
// negative code on interface misuse.
long pump_parse(void* p, PyObject* bufs) {
  Ctx* ctx = static_cast<Ctx*>(p);
  clear_outputs(ctx);
  PyObject* fast = PySequence_Fast(bufs, "bufs must be a sequence");
  if (fast == nullptr) {
    PyErr_Clear();
    return -1;
  }
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    char* data;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(item, &data, &len) != 0) {
      PyErr_Clear();
      Py_DECREF(fast);
      return -2;
    }
    if (len > kInt32Max) {
      Py_DECREF(fast);
      return -3;
    }
    parse_boxcar(ctx, static_cast<int32_t>(i), data, len);
  }
  Py_DECREF(fast);
  return static_cast<long>(ctx->cols[0].size());
}

// Copy the parsed columns into a caller-owned [NF, n] int32 buffer.
long pump_fill(void* p, int32_t* dst, long n) {
  Ctx* ctx = static_cast<Ctx*>(p);
  if (static_cast<long>(ctx->cols[0].size()) != n) return -1;
  for (int f = 0; f < NF; ++f)
    std::memcpy(dst + static_cast<long>(f) * n, ctx->cols[f].data(),
                sizeof(int32_t) * n);
  return 0;
}

long pump_arena_size(void* p) {
  return static_cast<long>(static_cast<Ctx*>(p)->arena.size());
}

long pump_fill_arena(void* p, char* dst, long n) {
  Ctx* ctx = static_cast<Ctx*>(p);
  if (static_cast<long>(ctx->arena.size()) != n) return -1;
  std::memcpy(dst, ctx->arena.data(), n);
  return 0;
}

// Newly interned entities since the last parse (owned lists; caller takes).
PyObject* pump_take_new_docs(void* p) {
  Ctx* ctx = static_cast<Ctx*>(p);
  PyObject* out = ctx->new_docs;
  ctx->new_docs = PyList_New(0);
  return out;
}

PyObject* pump_take_new_clients(void* p) {
  Ctx* ctx = static_cast<Ctx*>(p);
  PyObject* out = ctx->new_clients;
  ctx->new_clients = PyList_New(0);
  return out;
}

PyObject* pump_take_new_channels(void* p) {
  Ctx* ctx = static_cast<Ctx*>(p);
  PyObject* out = ctx->new_channels;
  ctx->new_channels = PyList_New(0);
  return out;
}

PyObject* pump_take_new_keys(void* p) {
  Ctx* ctx = static_cast<Ctx*>(p);
  PyObject* out = ctx->new_keys;
  ctx->new_keys = PyList_New(0);
  return out;
}

// Checkpoint-restore preloads: rebuild interner state so ordinals assigned
// after a restart continue the persisted numbering.
long pump_preload_doc(void* p, const char* doc_id) {
  return intern_doc(static_cast<Ctx*>(p), doc_id);
}

long pump_preload_client(void* p, long doc_ord, const char* cid, long ord) {
  Ctx* ctx = static_cast<Ctx*>(p);
  if (doc_ord < 0 ||
      doc_ord >= static_cast<long>(ctx->doc_clients.size()))
    return -1;
  auto& m = ctx->doc_clients[doc_ord];
  m[cid] = static_cast<int32_t>(ord);
  if (ctx->doc_next_ord[doc_ord] <= ord)
    ctx->doc_next_ord[doc_ord] = static_cast<int32_t>(ord + 1);
  return 0;
}

long pump_doc_next_ord(void* p, long doc_ord) {
  Ctx* ctx = static_cast<Ctx*>(p);
  if (doc_ord < 0 || doc_ord >= static_cast<long>(ctx->doc_next_ord.size()))
    return -1;
  return ctx->doc_next_ord[doc_ord];
}

long pump_nf() { return NF; }

}  // extern "C"
