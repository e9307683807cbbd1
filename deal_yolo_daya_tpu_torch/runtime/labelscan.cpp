// labelscan — native scanner for annotation-JSON label cells.
//
// The datakit pipeline's hottest host loop is "json.loads per row, walk
// objects[].polygon.ptList" (reference pattern: core/processor.py:341-366,
// 392-398). This scanner extracts padded box arrays for whole string columns
// in one C++ pass, multithreaded, without materializing Python object trees.
//
// Schema handled: {"width":W,"height":H,"objects":[{"name":...,
//   "polygon":{"ptList":[{"x":N,"y":N},...]}}, ...]}
// The scanner is a real tokenizer w.r.t. strings (escape-aware), so label
// text containing braces/brackets cannot confuse it. Malformed cells yield
// zero boxes (matching the tolerant Python path).
//
// Exposed C ABI (ctypes):
//   void scan_boxes(const char** rows, int64 n_rows, int two_point_only,
//                   int max_boxes, float* out_boxes /* n*max*4 */,
//                   uint8* out_mask /* n*max */, int32* out_counts /* n */,
//                   float* out_wh /* n*2, -1 if absent */, int n_threads);

#include <cstdint>
#include <cstdio>
#include <charconv>
#include <cstring>
#include <cctype>
#include <cstdlib>
#include <algorithm>
#include <thread>
#include <vector>
#include <cmath>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool eof() const { return p >= end; }
};

inline void skip_ws(Cursor& c) {
  while (!c.eof() && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' || *c.p == '\r')) ++c.p;
}

// Skip a JSON string assuming c.p points at the opening quote.
inline bool skip_string(Cursor& c) {
  if (c.eof() || *c.p != '"') return false;
  ++c.p;
  while (!c.eof()) {
    if (*c.p == '\\') { c.p += 2; continue; }
    if (*c.p == '"') { ++c.p; return true; }
    ++c.p;
  }
  return false;
}

inline bool parse_number(Cursor& c, double* out) {
  char* endp = nullptr;
  double v = strtod(c.p, &endp);
  if (endp == c.p) return false;
  c.p = endp;
  *out = v;
  return true;
}

// Skip any JSON value (object/array/string/number/literal).
bool skip_value(Cursor& c) {
  skip_ws(c);
  if (c.eof()) return false;
  char ch = *c.p;
  if (ch == '"') return skip_string(c);
  if (ch == '{' || ch == '[') {
    char open = ch, close = (ch == '{') ? '}' : ']';
    int depth = 0;
    while (!c.eof()) {
      char d = *c.p;
      if (d == '"') { if (!skip_string(c)) return false; continue; }
      if (d == open) ++depth;
      else if (d == close) { --depth; if (depth == 0) { ++c.p; return true; } }
      ++c.p;
    }
    return false;
  }
  // number / true / false / null
  while (!c.eof() && *c.p != ',' && *c.p != '}' && *c.p != ']') ++c.p;
  return true;
}

// Match a key name at the cursor (cursor at opening quote). On match the
// cursor advances past `"key"` and the following `:`; else it is restored.
bool match_key(Cursor& c, const char* key) {
  const char* save = c.p;
  if (*c.p != '"') return false;
  ++c.p;
  size_t klen = strlen(key);
  if ((size_t)(c.end - c.p) < klen + 1 || memcmp(c.p, key, klen) != 0 || c.p[klen] != '"') {
    c.p = save;
    return false;
  }
  c.p += klen + 1;
  skip_ws(c);
  if (c.eof() || *c.p != ':') { c.p = save; return false; }
  ++c.p;
  return true;
}

struct Pt { double x, y; bool has_x = false, has_y = false; };

// Parse a ptList array: [{"x":..,"y":..}, ...]. Cursor at '['.
int parse_ptlist(Cursor& c, std::vector<Pt>& pts) {
  pts.clear();
  skip_ws(c);
  if (c.eof() || *c.p != '[') return -1;
  ++c.p;
  while (true) {
    skip_ws(c);
    if (c.eof()) return -1;
    if (*c.p == ']') { ++c.p; break; }
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p != '{') { if (!skip_value(c)) return -1; continue; }
    // point object
    ++c.p;
    Pt pt;
    while (true) {
      skip_ws(c);
      if (c.eof()) return -1;
      if (*c.p == '}') { ++c.p; break; }
      if (*c.p == ',') { ++c.p; continue; }
      if (*c.p == '"') {
        Cursor probe = c;
        if (match_key(c, "x")) {
          skip_ws(c);
          double v;
          if (*c.p == 'n') { skip_value(c); }            // null
          else if (parse_number(c, &v)) { pt.x = v; pt.has_x = true; }
          else return -1;
        } else if (match_key(c, "y")) {
          skip_ws(c);
          double v;
          if (*c.p == 'n') { skip_value(c); }
          else if (parse_number(c, &v)) { pt.y = v; pt.has_y = true; }
          else return -1;
        } else {
          c = probe;
          if (!skip_string(c)) return -1;                 // key
          skip_ws(c);
          if (c.eof() || *c.p != ':') return -1;
          ++c.p;
          if (!skip_value(c)) return -1;                  // value
        }
      } else {
        return -1;
      }
    }
    pts.push_back(pt);
  }
  return (int)pts.size();
}

// Scan one row. Returns number of boxes written (<= max_boxes).
int scan_row(const char* json, int64_t jlen, int two_point_only,
             int max_boxes, float* boxes, uint8_t* mask, float* wh) {
  wh[0] = -1.0f; wh[1] = -1.0f;
  if (json == nullptr || jlen < 0) return 0;
  Cursor c{json, json + jlen};
  skip_ws(c);
  if (c.eof() || *c.p != '{') return 0;
  ++c.p;

  int n_boxes = 0;
  std::vector<Pt> pts;

  // top-level key loop
  while (!c.eof()) {
    skip_ws(c);
    if (c.eof()) break;
    if (*c.p == '}') break;
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p != '"') break;

    Cursor probe = c;
    if (match_key(c, "width")) {
      skip_ws(c);
      double v;
      if (parse_number(c, &v)) wh[0] = (float)v; else if (!skip_value(c)) break;
      continue;
    }
    c = probe;
    if (match_key(c, "height")) {
      skip_ws(c);
      double v;
      if (parse_number(c, &v)) wh[1] = (float)v; else if (!skip_value(c)) break;
      continue;
    }
    c = probe;
    if (match_key(c, "objects")) {
      skip_ws(c);
      if (c.eof() || *c.p != '[') { if (!skip_value(c)) break; continue; }
      ++c.p;
      // objects array
      while (true) {
        skip_ws(c);
        if (c.eof()) break;
        if (*c.p == ']') { ++c.p; break; }
        if (*c.p == ',') { ++c.p; continue; }
        if (*c.p != '{') { if (!skip_value(c)) break; continue; }
        // one object: find polygon.ptList
        ++c.p;
        bool got_pts = false;
        int n_pts = 0;
        while (true) {
          skip_ws(c);
          if (c.eof()) break;
          if (*c.p == '}') { ++c.p; break; }
          if (*c.p == ',') { ++c.p; continue; }
          if (*c.p != '"') { break; }
          Cursor oprobe = c;
          if (match_key(c, "polygon")) {
            skip_ws(c);
            if (c.eof() || *c.p != '{') { if (!skip_value(c)) break; continue; }
            ++c.p;
            while (true) {
              skip_ws(c);
              if (c.eof()) break;
              if (*c.p == '}') { ++c.p; break; }
              if (*c.p == ',') { ++c.p; continue; }
              if (*c.p != '"') break;
              Cursor pprobe = c;
              if (match_key(c, "ptList")) {
                n_pts = parse_ptlist(c, pts);
                got_pts = n_pts >= 0;
              } else {
                c = pprobe;
                if (!skip_string(c)) break;
                skip_ws(c);
                if (c.eof() || *c.p != ':') break;
                ++c.p;
                if (!skip_value(c)) break;
              }
            }
          } else {
            c = oprobe;
            if (!skip_string(c)) break;
            skip_ws(c);
            if (c.eof() || *c.p != ':') break;
            ++c.p;
            if (!skip_value(c)) break;
          }
        }
        // finalize box for this object
        if (got_pts && n_boxes < max_boxes) {
          if (two_point_only) {
            // IoU-filter semantics: exactly 2 complete points
            if ((int)pts.size() == 2 && pts[0].has_x && pts[0].has_y
                && pts[1].has_x && pts[1].has_y) {
              float x1 = (float)std::min(pts[0].x, pts[1].x);
              float y1 = (float)std::min(pts[0].y, pts[1].y);
              float x2 = (float)std::max(pts[0].x, pts[1].x);
              float y2 = (float)std::max(pts[0].y, pts[1].y);
              float* b = boxes + n_boxes * 4;
              b[0] = x1; b[1] = y1; b[2] = x2; b[3] = y2;
              mask[n_boxes] = 1;
              ++n_boxes;
            }
          } else {
            // poly->bbox semantics: x and y extents accumulate independently
            // (a half-null point still contributes its present coordinate,
            // matching the Python parser)
            double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
            bool any_x = false, any_y = false;
            for (const Pt& p : pts) {
              if (p.has_x) { any_x = true; minx = std::min(minx, p.x); maxx = std::max(maxx, p.x); }
              if (p.has_y) { any_y = true; miny = std::min(miny, p.y); maxy = std::max(maxy, p.y); }
            }
            bool any = any_x && any_y;
            if (any) {
              float* b = boxes + n_boxes * 4;
              b[0] = (float)minx; b[1] = (float)miny;
              b[2] = (float)maxx; b[3] = (float)maxy;
              mask[n_boxes] = 1;
              ++n_boxes;
            }
          }
        }
      }
      continue;
    }
    // other top-level key
    c = probe;
    if (!skip_string(c)) break;
    skip_ws(c);
    if (c.eof() || *c.p != ':') break;
    ++c.p;
    if (!skip_value(c)) break;
  }
  return n_boxes;
}

// ---------------------------------------------------------------------------
// Structural annotation scanner (strict).
//
// While scan_boxes answers "what boxes are in this cell", the structural
// scanner produces a full columnar *annotation table* for a string column:
// per-row parse status + width/height + the byte span of the objects array,
// and per-object the spans of the object / name value / polygon value /
// ptList value, the unescaped name text (written into a shared arena), the
// point count and the polygon's coordinate extents. Downstream steps rewrite
// cells by splicing replacement text into these spans instead of
// json.loads/json.dumps round-trips.
//
// Strictness: rows are validated with full JSON grammar (incl. string escape
// rules and Python's NaN/Infinity extensions) so that status codes agree
// with json.loads: 0 = null input, 1 = ok top-level object, 2 = invalid
// JSON, 3 = valid JSON but top-level not an object.
// ---------------------------------------------------------------------------

namespace ann {

constexpr int32_t F_NAME_KIND_MASK = 0x3;  // 0 absent, 1 string, 2 null, 3 other
constexpr int32_t F_BBOX_OK = 1 << 2;
constexpr int32_t F_TWOPT_OK = 1 << 3;
constexpr int32_t F_HAS_POLY = 1 << 4;
constexpr int32_t F_HAS_PTLIST = 1 << 5;
constexpr int32_t F_POLY_EMPTY = 1 << 6;
constexpr int32_t F_OBJ_EMPTY = 1 << 7;
constexpr int32_t F_POLY_IS_OBJ = 1 << 8;
constexpr int32_t F_PTLIST_IS_ARR = 1 << 9;

constexpr uint8_t ROW_NULL = 0;
constexpr uint8_t ROW_OK = 1;
constexpr uint8_t ROW_INVALID = 2;
constexpr uint8_t ROW_NON_OBJECT = 3;

constexpr uint8_t RF_NONDICT_OBJECTS = 1;  // objects array holds non-dict entries

struct RowOut {
  uint8_t status = ROW_NULL;
  uint8_t objects_kind = 0;  // 0 absent, 1 list, 2 present-not-list
  uint8_t row_flags = 0;
  int32_t objects_s = -1, objects_e = -1;
  double w = std::nan(""), h = std::nan("");
};

struct ObjOut {
  int32_t obj_s = -1, obj_e = -1;
  int32_t name_s = -1, name_e = -1;
  int32_t ptlist_s = -1, ptlist_e = -1;
  int32_t poly_s = -1, poly_e = -1;
  int32_t npts = 0;
  int32_t flags = 0;
  int32_t name_len = 0;                    // unescaped UTF-8 byte length
  const char* name_tok_s = nullptr;        // raw (escaped) content or token
  const char* name_tok_e = nullptr;
  bool name_is_escaped_string = false;     // content needs json_unescape
  double box[4] = {0, 0, 0, 0};
};

// Unescape JSON string content (between quotes). Returns output byte length
// or -1 on a bad escape. dst may be null to count only. Lone surrogates are
// replaced with U+FFFD.
int64_t json_unescape(const char* src, int64_t len, char* dst) {
  int64_t out = 0;
  auto put = [&](char ch) { if (dst) dst[out] = ch; ++out; };
  auto put_cp = [&](uint32_t cp) {
    if (cp < 0x80) put((char)cp);
    else if (cp < 0x800) {
      put((char)(0xC0 | (cp >> 6)));
      put((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      put((char)(0xE0 | (cp >> 12)));
      put((char)(0x80 | ((cp >> 6) & 0x3F)));
      put((char)(0x80 | (cp & 0x3F)));
    } else {
      put((char)(0xF0 | (cp >> 18)));
      put((char)(0x80 | ((cp >> 12) & 0x3F)));
      put((char)(0x80 | ((cp >> 6) & 0x3F)));
      put((char)(0x80 | (cp & 0x3F)));
    }
  };
  auto hex4 = [&](const char* p, uint32_t* v) -> bool {
    uint32_t acc = 0;
    for (int i = 0; i < 4; ++i) {
      char h = p[i];
      uint32_t d;
      if (h >= '0' && h <= '9') d = h - '0';
      else if (h >= 'a' && h <= 'f') d = h - 'a' + 10;
      else if (h >= 'A' && h <= 'F') d = h - 'A' + 10;
      else return false;
      acc = (acc << 4) | d;
    }
    *v = acc;
    return true;
  };
  for (int64_t i = 0; i < len;) {
    char ch = src[i];
    if (ch != '\\') { put(ch); ++i; continue; }
    if (i + 1 >= len) return -1;
    char e = src[i + 1];
    i += 2;
    switch (e) {
      case '"': put('"'); break;
      case '\\': put('\\'); break;
      case '/': put('/'); break;
      case 'b': put('\b'); break;
      case 'f': put('\f'); break;
      case 'n': put('\n'); break;
      case 'r': put('\r'); break;
      case 't': put('\t'); break;
      case 'u': {
        if (i + 4 > len) return -1;
        uint32_t cp;
        if (!hex4(src + i, &cp)) return -1;
        i += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF) {
          if (i + 6 <= len && src[i] == '\\' && src[i + 1] == 'u') {
            uint32_t lo;
            if (!hex4(src + i + 2, &lo)) return -1;
            if (lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              i += 6;
            } else {
              cp = 0xFFFD;
            }
          } else {
            cp = 0xFFFD;
          }
        } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
          cp = 0xFFFD;
        }
        put_cp(cp);
        break;
      }
      default:
        return -1;
    }
  }
  return out;
}

// Strict string validation (cursor at opening quote).
bool v_string(Cursor& c) {
  if (c.eof() || *c.p != '"') return false;
  ++c.p;
  while (!c.eof()) {
    unsigned char ch = (unsigned char)*c.p;
    if (ch == '"') { ++c.p; return true; }
    if (ch == '\\') {
      ++c.p;
      if (c.eof()) return false;
      char e = *c.p;
      if (e == 'u') {
        if (c.end - c.p < 5) return false;
        for (int i = 1; i <= 4; ++i)
          if (!isxdigit((unsigned char)c.p[i])) return false;
        c.p += 5;
        continue;
      }
      if (!strchr("\"\\/bfnrt", e)) return false;
      ++c.p;
      continue;
    }
    if (ch < 0x20) return false;
    ++c.p;
  }
  return false;
}

// Strict number (JSON grammar + Python's NaN/Infinity extensions).
bool v_number(Cursor& c, double* out) {
  const char* start = c.p;
  bool neg = false;
  if (!c.eof() && *c.p == '-') { neg = true; ++c.p; }
  if (!c.eof() && (c.end - c.p) >= 8 && memcmp(c.p, "Infinity", 8) == 0) {
    c.p += 8;
    if (out) *out = neg ? -INFINITY : INFINITY;
    return true;
  }
  if (!neg && !c.eof() && (c.end - c.p) >= 3 && memcmp(c.p, "NaN", 3) == 0) {
    c.p += 3;
    if (out) *out = std::nan("");
    return true;
  }
  if (c.eof() || !isdigit((unsigned char)*c.p)) return false;
  if (*c.p == '0') ++c.p;
  else while (!c.eof() && isdigit((unsigned char)*c.p)) ++c.p;
  if (!c.eof() && *c.p == '.') {
    ++c.p;
    if (c.eof() || !isdigit((unsigned char)*c.p)) return false;
    while (!c.eof() && isdigit((unsigned char)*c.p)) ++c.p;
  }
  if (!c.eof() && (*c.p == 'e' || *c.p == 'E')) {
    ++c.p;
    if (!c.eof() && (*c.p == '+' || *c.p == '-')) ++c.p;
    if (c.eof() || !isdigit((unsigned char)*c.p)) return false;
    while (!c.eof() && isdigit((unsigned char)*c.p)) ++c.p;
  }
  if (out) { char* e2 = nullptr; *out = strtod(start, &e2); }
  return true;
}

bool v_value(Cursor& c, int depth);

bool v_object(Cursor& c, int depth) {
  ++c.p;
  skip_ws(c);
  if (!c.eof() && *c.p == '}') { ++c.p; return true; }
  while (true) {
    skip_ws(c);
    if (!v_string(c)) return false;
    skip_ws(c);
    if (c.eof() || *c.p != ':') return false;
    ++c.p;
    if (!v_value(c, depth)) return false;
    skip_ws(c);
    if (c.eof()) return false;
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p == '}') { ++c.p; return true; }
    return false;
  }
}

bool v_array(Cursor& c, int depth) {
  ++c.p;
  skip_ws(c);
  if (!c.eof() && *c.p == ']') { ++c.p; return true; }
  while (true) {
    if (!v_value(c, depth)) return false;
    skip_ws(c);
    if (c.eof()) return false;
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p == ']') { ++c.p; return true; }
    return false;
  }
}

bool v_value(Cursor& c, int depth) {
  if (depth > 400) return false;
  skip_ws(c);
  if (c.eof()) return false;
  char ch = *c.p;
  if (ch == '"') return v_string(c);
  if (ch == '{') return v_object(c, depth + 1);
  if (ch == '[') return v_array(c, depth + 1);
  if (ch == 't') {
    if (c.end - c.p >= 4 && memcmp(c.p, "true", 4) == 0) { c.p += 4; return true; }
    return false;
  }
  if (ch == 'f') {
    if (c.end - c.p >= 5 && memcmp(c.p, "false", 5) == 0) { c.p += 5; return true; }
    return false;
  }
  if (ch == 'n') {
    if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) { c.p += 4; return true; }
    return false;
  }
  return v_number(c, nullptr);
}

// Strict ptList parse with extents. Cursor at the value after "ptList":.
bool parse_ptlist(Cursor& c, const char* base, ObjOut& o) {
  skip_ws(c);
  if (c.eof()) return false;
  o.ptlist_s = (int32_t)(c.p - base);
  o.flags |= F_HAS_PTLIST;
  // Reset extents so a duplicate ptList key cleanly overrides the first.
  o.npts = 0;
  o.flags &= ~(F_BBOX_OK | F_TWOPT_OK | F_PTLIST_IS_ARR);
  if (*c.p != '[') {
    if (!v_value(c, 2)) return false;
    o.ptlist_e = (int32_t)(c.p - base);
    return true;
  }
  o.flags |= F_PTLIST_IS_ARR;
  ++c.p;
  int npts = 0, ncomplete = 0;
  bool any_x = false, any_y = false;
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  skip_ws(c);
  if (!c.eof() && *c.p == ']') { ++c.p; }
  else while (true) {
    skip_ws(c);
    if (c.eof()) return false;
    if (*c.p == '{') {
      // point object: strict walk with x/y capture (last occurrence wins)
      ++c.p;
      double px = 0, py = 0;
      bool has_x = false, has_y = false;
      skip_ws(c);
      if (!c.eof() && *c.p == '}') { ++c.p; }
      else while (true) {
        skip_ws(c);
        if (c.eof() || *c.p != '"') return false;
        Cursor probe = c;
        bool is_x = match_key(c, "x");
        bool is_y = false;
        if (!is_x) { c = probe; is_y = match_key(c, "y"); }
        if (is_x || is_y) {
          skip_ws(c);
          if (c.eof()) return false;
          if (*c.p == 'n' && c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
            c.p += 4;
            if (is_x) has_x = false; else has_y = false;
          } else if (*c.p == '"' || *c.p == '{' || *c.p == '[' ||
                     *c.p == 't' || *c.p == 'f') {
            if (!v_value(c, 3)) return false;  // non-numeric: treat as absent
            if (is_x) has_x = false; else has_y = false;
          } else {
            double v;
            if (!v_number(c, &v)) return false;
            if (is_x) { px = v; has_x = true; } else { py = v; has_y = true; }
          }
        } else {
          c = probe;
          if (!v_string(c)) return false;
          skip_ws(c);
          if (c.eof() || *c.p != ':') return false;
          ++c.p;
          if (!v_value(c, 3)) return false;
        }
        skip_ws(c);
        if (c.eof()) return false;
        if (*c.p == ',') { ++c.p; continue; }
        if (*c.p == '}') { ++c.p; break; }
        return false;
      }
      ++npts;
      if (has_x) { any_x = true; minx = std::min(minx, px); maxx = std::max(maxx, px); }
      if (has_y) { any_y = true; miny = std::min(miny, py); maxy = std::max(maxy, py); }
      if (has_x && has_y) ++ncomplete;
    } else {
      if (!v_value(c, 2)) return false;
      ++npts;
    }
    skip_ws(c);
    if (c.eof()) return false;
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p == ']') { ++c.p; break; }
    return false;
  }
  o.ptlist_e = (int32_t)(c.p - base);
  o.npts = npts;
  if (any_x && any_y) {
    o.flags |= F_BBOX_OK;
    o.box[0] = minx; o.box[1] = miny; o.box[2] = maxx; o.box[3] = maxy;
  }
  if (npts == 2 && ncomplete == 2) o.flags |= F_TWOPT_OK;
  return true;
}

// Strict parse of one annotation object (cursor at '{').
bool parse_object(Cursor& c, const char* base, ObjOut& o) {
  o.obj_s = (int32_t)(c.p - base);
  ++c.p;
  skip_ws(c);
  if (!c.eof() && *c.p == '}') {
    ++c.p;
    o.obj_e = (int32_t)(c.p - base);
    o.flags |= F_OBJ_EMPTY;
    return true;
  }
  while (true) {
    skip_ws(c);
    if (c.eof() || *c.p != '"') return false;
    Cursor probe = c;
    if (match_key(c, "name")) {
      skip_ws(c);
      if (c.eof()) return false;
      o.name_s = (int32_t)(c.p - base);
      o.flags &= ~F_NAME_KIND_MASK;
      o.name_is_escaped_string = false;
      if (*c.p == '"') {
        const char* content = c.p + 1;
        if (!v_string(c)) return false;
        o.name_e = (int32_t)(c.p - base);
        o.name_tok_s = content;
        o.name_tok_e = c.p - 1;  // before closing quote
        o.name_is_escaped_string = true;
        int64_t ulen = json_unescape(content, o.name_tok_e - content, nullptr);
        if (ulen < 0) return false;
        o.name_len = (int32_t)ulen;
        o.flags |= 1;
      } else if (*c.p == 'n' && c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
        c.p += 4;
        o.name_e = (int32_t)(c.p - base);
        o.name_tok_s = o.name_tok_e = nullptr;
        o.name_len = 0;
        o.flags |= 2;
      } else {
        const char* vstart = c.p;
        if (!v_value(c, 1)) return false;
        o.name_e = (int32_t)(c.p - base);
        o.name_tok_s = vstart;
        o.name_tok_e = c.p;  // raw token text stands in for str(value)
        o.name_len = (int32_t)(o.name_tok_e - o.name_tok_s);
        o.flags |= 3;
      }
    } else {
      c = probe;
      if (match_key(c, "polygon")) {
        skip_ws(c);
        if (c.eof()) return false;
        o.poly_s = (int32_t)(c.p - base);
        o.flags |= F_HAS_POLY;
        // Reset polygon/ptList state so a duplicate "polygon" key cleanly
        // overrides the first (json.loads last-key-wins parity, like the
        // duplicate-ptList reset in parse_ptlist).
        o.flags &= ~(F_POLY_IS_OBJ | F_POLY_EMPTY | F_HAS_PTLIST |
                     F_BBOX_OK | F_TWOPT_OK | F_PTLIST_IS_ARR);
        o.ptlist_s = o.ptlist_e = -1;
        o.npts = 0;
        if (*c.p == '{') {
          o.flags |= F_POLY_IS_OBJ;
          ++c.p;
          skip_ws(c);
          if (!c.eof() && *c.p == '}') {
            ++c.p;
            o.flags |= F_POLY_EMPTY;
          } else {
            while (true) {
              skip_ws(c);
              if (c.eof() || *c.p != '"') return false;
              Cursor pprobe = c;
              if (match_key(c, "ptList")) {
                if (!parse_ptlist(c, base, o)) return false;
              } else {
                c = pprobe;
                if (!v_string(c)) return false;
                skip_ws(c);
                if (c.eof() || *c.p != ':') return false;
                ++c.p;
                if (!v_value(c, 2)) return false;
              }
              skip_ws(c);
              if (c.eof()) return false;
              if (*c.p == ',') { ++c.p; continue; }
              if (*c.p == '}') { ++c.p; break; }
              return false;
            }
          }
          o.poly_e = (int32_t)(c.p - base);
        } else {
          if (!v_value(c, 1)) return false;
          o.poly_e = (int32_t)(c.p - base);
        }
      } else {
        c = probe;
        if (!v_string(c)) return false;
        skip_ws(c);
        if (c.eof() || *c.p != ':') return false;
        ++c.p;
        if (!v_value(c, 1)) return false;
      }
    }
    skip_ws(c);
    if (c.eof()) return false;
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p == '}') {
      ++c.p;
      o.obj_e = (int32_t)(c.p - base);
      return true;
    }
    return false;
  }
}

// Full strict scan of one row.
void scan_row(const char* json, int64_t jlen, RowOut& row,
              std::vector<ObjOut>& objs) {
  objs.clear();
  row = RowOut{};
  if (json == nullptr || jlen < 0) { row.status = ROW_NULL; return; }
  Cursor c{json, json + jlen};
  skip_ws(c);
  if (c.eof()) { row.status = ROW_INVALID; return; }  // json.loads("") raises
  const char* base = json;
  if (*c.p != '{') {
    Cursor c2 = c;
    if (v_value(c2, 0)) {
      skip_ws(c2);
      row.status = c2.eof() ? ROW_NON_OBJECT : ROW_INVALID;
    } else {
      row.status = ROW_INVALID;
    }
    return;
  }
  ++c.p;
  skip_ws(c);
  bool ok = true;
  if (!c.eof() && *c.p == '}') { ++c.p; }
  else while (true) {
    skip_ws(c);
    if (c.eof() || *c.p != '"') { ok = false; break; }
    Cursor probe = c;
    if (match_key(c, "width")) {
      skip_ws(c);
      double v;
      Cursor vprobe = c;
      if (!c.eof() && v_number(c, &v)) row.w = v;
      else { c = vprobe; row.w = std::nan(""); if (!v_value(c, 1)) { ok = false; break; } }
    } else {
      c = probe;
      if (match_key(c, "height")) {
        skip_ws(c);
        double v;
        Cursor vprobe = c;
        if (!c.eof() && v_number(c, &v)) row.h = v;
        else { c = vprobe; row.h = std::nan(""); if (!v_value(c, 1)) { ok = false; break; } }
      } else {
        c = probe;
        if (match_key(c, "objects")) {
          skip_ws(c);
          if (c.eof()) { ok = false; break; }
          if (*c.p != '[') {
            // duplicate key: json.loads keeps the LAST occurrence
            objs.clear();
            row.row_flags = 0;
            row.objects_kind = 2;
            row.objects_s = row.objects_e = -1;
            if (!v_value(c, 1)) { ok = false; break; }
          } else {
            objs.clear();
            row.row_flags = 0;
            row.objects_kind = 1;
            row.objects_s = (int32_t)(c.p - base);
            ++c.p;
            skip_ws(c);
            if (!c.eof() && *c.p == ']') {
              ++c.p;
              row.objects_e = (int32_t)(c.p - base);
            } else {
              while (true) {
                skip_ws(c);
                if (c.eof()) { ok = false; break; }
                if (*c.p == '{') {
                  ObjOut o;
                  if (!parse_object(c, base, o)) { ok = false; break; }
                  objs.push_back(o);
                } else {
                  row.row_flags |= RF_NONDICT_OBJECTS;
                  if (!v_value(c, 1)) { ok = false; break; }
                }
                skip_ws(c);
                if (c.eof()) { ok = false; break; }
                if (*c.p == ',') { ++c.p; continue; }
                if (*c.p == ']') {
                  ++c.p;
                  row.objects_e = (int32_t)(c.p - base);
                  break;
                }
                ok = false;
                break;
              }
              if (!ok) break;
            }
          }
        } else {
          c = probe;
          if (!v_string(c)) { ok = false; break; }
          skip_ws(c);
          if (c.eof() || *c.p != ':') { ok = false; break; }
          ++c.p;
          if (!v_value(c, 1)) { ok = false; break; }
        }
      }
    }
    skip_ws(c);
    if (c.eof()) { ok = false; break; }
    if (*c.p == ',') { ++c.p; continue; }
    if (*c.p == '}') { ++c.p; break; }
    ok = false;
    break;
  }
  if (ok) {
    skip_ws(c);
    ok = c.eof();  // "extra data" also fails json.loads
  }
  if (!ok) {
    objs.clear();
    row = RowOut{};
    row.status = ROW_INVALID;
    return;
  }
  row.status = ROW_OK;
}

}  // namespace ann

// Row source: either a char** of NUL-terminated cells (None -> nullptr) or
// one contiguous utf-8 blob with int64 offsets[n+1] + optional validity —
// the zero-copy shape of an Arrow string column. Exported functions take
// both; rows == nullptr selects blob mode.
struct RowSrc {
  const char* const* rows;
  const char* blob;
  const int64_t* off;
  const uint8_t* valid;
  inline bool is_null(int64_t i) const {
    return rows ? rows[i] == nullptr : (valid && !valid[i]);
  }
  inline const char* ptr(int64_t i) const {
    return rows ? rows[i] : blob + off[i];
  }
  inline int64_t len(int64_t i) const {
    if (rows) return rows[i] ? (int64_t)strlen(rows[i]) : -1;
    if (valid && !valid[i]) return -1;
    return off[i + 1] - off[i];
  }
};

}  // namespace

extern "C" {

// Pass 1: per-row dict-object count and total unescaped name bytes.
void count_ann(const char** rows, int64_t n_rows, int32_t* out_nobj,
               int64_t* out_name_bytes, int n_threads, const char* blob,
               const int64_t* boff, const uint8_t* bvalid) {
  if (n_threads < 1) n_threads = 1;
  RowSrc src{rows, blob, boff, bvalid};
  auto work = [&](int64_t start, int64_t end) {
    ann::RowOut row;
    std::vector<ann::ObjOut> objs;
    for (int64_t i = start; i < end; ++i) {
      ann::scan_row(src.ptr(i), src.len(i), row, objs);
      out_nobj[i] = (int32_t)objs.size();
      int64_t nb = 0;
      for (const auto& o : objs) nb += o.name_len;
      out_name_bytes[i] = nb;
    }
  };
  if (n_threads == 1 || n_rows < 1024) { work(0, n_rows); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(s + chunk, n_rows);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

// Pass 2: fill the annotation table at offsets computed from pass 1.
// row_i32: (n,6) = status, objects_kind, row_flags, objects_s, objects_e, 0
// obj_i32: (m,12) = obj_s,obj_e,name_s,name_e,ptlist_s,ptlist_e,poly_s,poly_e,
//                   npts,flags,name_len,0
void scan_ann(const char** rows, int64_t n_rows, const int64_t* obj_off,
              const int64_t* name_off, int32_t* row_i32, double* row_wh,
              int32_t* obj_i32, double* obj_box, int64_t* name_pos,
              char* arena, int n_threads, const char* blob,
              const int64_t* boff, const uint8_t* bvalid) {
  if (n_threads < 1) n_threads = 1;
  RowSrc src{rows, blob, boff, bvalid};
  auto work = [&](int64_t start, int64_t end) {
    ann::RowOut row;
    std::vector<ann::ObjOut> objs;
    for (int64_t i = start; i < end; ++i) {
      ann::scan_row(src.ptr(i), src.len(i), row, objs);
      int32_t* r = row_i32 + i * 6;
      r[0] = row.status;
      r[1] = row.objects_kind;
      r[2] = row.row_flags;
      r[3] = row.objects_s;
      r[4] = row.objects_e;
      r[5] = 0;
      row_wh[i * 2] = row.w;
      row_wh[i * 2 + 1] = row.h;
      int64_t ob = obj_off[i];
      int64_t arena_pos = name_off[i];
      // Defensive: never overflow the buffers sized by pass 1 (identical
      // input should give identical counts, but a mutated rows list between
      // passes must not corrupt memory).
      int64_t max_objs = obj_off[i + 1] - ob;
      int64_t arena_cap = name_off[i + 1];
      int64_t n = std::min<int64_t>((int64_t)objs.size(), max_objs);
      for (int64_t j = 0; j < n; ++j) {
        const ann::ObjOut& o = objs[j];
        int32_t* q = obj_i32 + (ob + j) * 12;
        q[0] = o.obj_s; q[1] = o.obj_e;
        q[2] = o.name_s; q[3] = o.name_e;
        q[4] = o.ptlist_s; q[5] = o.ptlist_e;
        q[6] = o.poly_s; q[7] = o.poly_e;
        q[8] = o.npts; q[9] = o.flags; q[10] = o.name_len; q[11] = 0;
        double* b = obj_box + (ob + j) * 4;
        b[0] = o.box[0]; b[1] = o.box[1]; b[2] = o.box[2]; b[3] = o.box[3];
        int64_t len = o.name_len;
        if (arena_pos + len > arena_cap) len = 0;
        if (len > 0 && o.name_tok_s != nullptr) {
          if (o.name_is_escaped_string) {
            ann::json_unescape(o.name_tok_s, o.name_tok_e - o.name_tok_s,
                               arena + arena_pos);
          } else {
            memcpy(arena + arena_pos, o.name_tok_s, len);
          }
        }
        name_pos[(ob + j) * 2] = arena_pos;
        name_pos[(ob + j) * 2 + 1] = arena_pos + len;
        arena_pos += len;
      }
    }
  };
  if (n_threads == 1 || n_rows < 1024) { work(0, n_rows); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(s + chunk, n_rows);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

extern "C" {

void scan_boxes(const char** rows, int64_t n_rows, int two_point_only,
                int max_boxes, float* out_boxes, uint8_t* out_mask,
                int32_t* out_counts, float* out_wh, int n_threads,
                const char* blob, const int64_t* boff,
                const uint8_t* bvalid) {
  if (n_threads < 1) n_threads = 1;
  RowSrc src{rows, blob, boff, bvalid};
  auto work = [&](int64_t start, int64_t end) {
    for (int64_t i = start; i < end; ++i) {
      float* b = out_boxes + i * (int64_t)max_boxes * 4;
      uint8_t* m = out_mask + i * (int64_t)max_boxes;
      memset(b, 0, sizeof(float) * max_boxes * 4);
      memset(m, 0, max_boxes);
      out_counts[i] = scan_row(src.ptr(i), src.len(i), two_point_only,
                               max_boxes, b, m, out_wh + i * 2);
    }
  };
  if (n_threads == 1 || n_rows < 1024) {
    work(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(s + chunk, n_rows);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Step-4 native applier: rewrite every object's polygon.ptList to its 2-point
// bbox, producing the whole new cell text in C++ (the last Python residue of
// the columnar step-4 path was per-object number formatting + per-row byte
// splicing — ~2.5 s @50k rows). Splice semantics mirror
// datakit/columnar.py::rewrite_ptlists; number text must be byte-identical
// to Python's repr()-based fmt_num (reference serializes via json.dumps —
// core/processor.py:281).
// ---------------------------------------------------------------------------

namespace rewrite {

// Python float repr: shortest round-trip digits; integral doubles < 2^53
// print as ints; scientific iff decimal exponent > 16 or < -4; fixed form
// always keeps a fractional digit ("...992.0"). Returns bytes written.
int fmt_num(double v, char* out) {
  if (std::isnan(v)) { memcpy(out, "NaN", 3); return 3; }
  if (std::isinf(v)) {
    if (v > 0) { memcpy(out, "Infinity", 8); return 8; }
    memcpy(out, "-Infinity", 9); return 9;
  }
  if (v == std::floor(v) && std::fabs(v) < 9007199254740992.0) {  // 2^53
    return (int)snprintf(out, 32, "%lld", (long long)v);
  }
  // shortest round-trip digits in scientific form ("d.ddde±XX", same
  // exponent format as printf %e / Python repr)
  char sci[40];
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto tc = std::to_chars(sci, sci + sizeof(sci) - 1, v,
                          std::chars_format::scientific);
  *tc.ptr = '\0';
#else
  // probe the shortest precision that round-trips (17x slower; only for
  // toolchains without float to_chars)
  int p = 17;
  for (int q = 1; q <= 17; ++q) {
    snprintf(sci, sizeof(sci), "%.*e", q - 1, v);
    if (strtod(sci, nullptr) == v) { p = q; break; }
  }
  snprintf(sci, sizeof(sci), "%.*e", p - 1, v);
#endif
  // split "[-]d[.ddd]e±XX" into digits + exponent
  char digits[24];
  int nd = 0;
  const char* s = sci;
  bool neg = (*s == '-');
  if (neg) ++s;
  for (; *s && *s != 'e'; ++s)
    if (*s != '.') digits[nd++] = *s;
  int exp10 = (int)strtol(s + 1, nullptr, 10);
  int decpt = exp10 + 1;  // digits before the decimal point in fixed form
  if (decpt > 16 || decpt < -3) {
    // scientific: printf's form already matches repr ("1e+16", "1.5e-07")
    int len = (int)strlen(sci);
    memcpy(out, sci, len);
    return len;
  }
  char* w = out;
  if (neg) *w++ = '-';
  if (decpt <= 0) {
    *w++ = '0'; *w++ = '.';
    for (int i = 0; i < -decpt; ++i) *w++ = '0';
    memcpy(w, digits, nd); w += nd;
  } else if (decpt >= nd) {
    memcpy(w, digits, nd); w += nd;
    for (int i = nd; i < decpt; ++i) *w++ = '0';
    *w++ = '.'; *w++ = '0';
  } else {
    memcpy(w, digits, decpt); w += decpt;
    *w++ = '.';
    memcpy(w, digits + decpt, nd - decpt); w += nd - decpt;
  }
  return (int)(w - out);
}

int bbox_text(const double* box, bool ok, char* out) {
  if (!ok) {
    static const char kNull[] =
        "[{\"x\": null, \"y\": null}, {\"x\": null, \"y\": null}]";
    int len = (int)sizeof(kNull) - 1;
    memcpy(out, kNull, len);
    return len;
  }
  char* w = out;
  static const char* kPre[4] = {"[{\"x\": ", ", \"y\": ", "}, {\"x\": ",
                               ", \"y\": "};
  for (int i = 0; i < 4; ++i) {
    size_t pl = strlen(kPre[i]);
    memcpy(w, kPre[i], pl); w += pl;
    w += fmt_num(box[i], w);
  }
  *w++ = '}'; *w++ = ']';
  return (int)(w - out);
}

}  // namespace rewrite

extern "C" {

// For each row with do_row[i], write the rewritten cell into out at
// cap_off[i] (per-row capacity offsets precomputed by the caller) and record
// the actual length in out_len[i] (-1 = skipped). obj ranges per row come
// from obj_off; obj_i32/obj_box are the scan_ann outputs.
void rewrite_ptlists_rows(const char** rows, int64_t n_rows,
                          const uint8_t* do_row, const int64_t* obj_off,
                          const int32_t* obj_i32, const double* obj_box,
                          char* out, const int64_t* cap_off, int64_t* out_len,
                          int n_threads, const char* blob, const int64_t* boff,
                          const uint8_t* bvalid) {
  if (n_threads < 1) n_threads = 1;
  RowSrc src{rows, blob, boff, bvalid};
  auto work = [&](int64_t start, int64_t end) {
    char text[192];
    for (int64_t i = start; i < end; ++i) {
      if (!do_row[i] || src.is_null(i)) { out_len[i] = -1; continue; }
      const char* raw = src.ptr(i);
      int64_t raw_len = src.len(i);
      char* w = out + cap_off[i];
      int64_t pos = 0;
      for (int64_t j = obj_off[i]; j < obj_off[i + 1]; ++j) {
        const int32_t* q = obj_i32 + j * 12;
        int32_t f = q[9];
        int tl = rewrite::bbox_text(obj_box + j * 4, f & (1 << 2) /*BBOX_OK*/,
                                    text);
        int64_t es, ee;          // replaced span
        char pre[40];            // bytes before the bbox text
        int pre_len = 0;
        const char* post = "";   // bytes after it
        if (f & (1 << 5)) {                       // F_HAS_PTLIST
          es = q[4]; ee = q[5];
        } else if (f & (1 << 8)) {                // F_POLY_IS_OBJ
          es = ee = q[6] + 1;
          memcpy(pre, "\"ptList\": ", 10); pre_len = 10;
          if (!(f & (1 << 6))) post = ", ";       // !F_POLY_EMPTY
        } else if (f & (1 << 4)) {                // F_HAS_POLY
          es = q[6]; ee = q[7];
          memcpy(pre, "{\"ptList\": ", 11); pre_len = 11;
          post = "}";
        } else {
          es = ee = q[0] + 1;
          memcpy(pre, "\"polygon\": {\"ptList\": ", 22); pre_len = 22;
          post = (f & (1 << 7)) ? "}" : "}, ";    // F_OBJ_EMPTY
        }
        memcpy(w, raw + pos, es - pos); w += es - pos;
        memcpy(w, pre, pre_len); w += pre_len;
        memcpy(w, text, tl); w += tl;
        size_t post_len = strlen(post);
        memcpy(w, post, post_len); w += post_len;
        pos = ee;
      }
      memcpy(w, raw + pos, raw_len - pos); w += raw_len - pos;
      out_len[i] = (w - out) - cap_off[i];
    }
  };
  if (n_threads == 1 || n_rows < 1024) { work(0, n_rows); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(s + chunk, n_rows);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

extern "C" {

// Generic byte-splice engine: item k copies rows[item_row[k]] applying its
// (sorted, non-overlapping) edits [edit_off[k], edit_off[k+1]) — edit e
// replaces source bytes [edit_s[e], edit_e[e]) with the EXPLICIT span
// rep[rep_s[e] .. rep_s[e]+rep_len[e]). Repeated replacement texts (e.g. the
// per-label name reps over millions of exploded step-7 rows) lay out once in
// rep and are referenced by every edit. Serves the step-6 rename and step-7
// single-object extraction appliers (datakit/columnar.py).
void splice_items2(const char** rows, const int64_t* item_row, int64_t n_items,
                   const int64_t* edit_off, const int64_t* edit_s,
                   const int64_t* edit_e, const char* rep,
                   const int64_t* rep_s, const int64_t* rep_len, char* out,
                   const int64_t* cap_off, int64_t* out_len, int n_threads,
                   const char* blob, const int64_t* boff,
                   const uint8_t* bvalid) {
  if (n_threads < 1) n_threads = 1;
  RowSrc src{rows, blob, boff, bvalid};
  auto work = [&](int64_t start, int64_t end) {
    for (int64_t k = start; k < end; ++k) {
      int64_t ri = item_row[k];
      if (src.is_null(ri)) { out_len[k] = -1; continue; }
      const char* raw = src.ptr(ri);
      int64_t raw_len = src.len(ri);
      char* w = out + cap_off[k];
      int64_t pos = 0;
      for (int64_t e = edit_off[k]; e < edit_off[k + 1]; ++e) {
        memcpy(w, raw + pos, edit_s[e] - pos); w += edit_s[e] - pos;
        memcpy(w, rep + rep_s[e], rep_len[e]); w += rep_len[e];
        pos = edit_e[e];
      }
      memcpy(w, raw + pos, raw_len - pos); w += raw_len - pos;
      out_len[k] = (w - out) - cap_off[k];
    }
  };
  if (n_threads == 1 || n_items < 1024) { work(0, n_items); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n_items + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min<int64_t>(s + chunk, n_items);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

extern "C" {

// Val-loop matcher (train/metrics.py::match_predictions, bit-identical):
// out[p*T + t] = 1 iff pred p greedily matches a same-class GT at IoU
// threshold thr[t]. Pair order/tie rules replicate the numpy reference:
// candidate pairs in (gt-major, pred-minor) row order, stable-sorted by
// descending IoU, first-come-first-matched. Host-side val matching was the
// @640 epoch tail's biggest cost (~0.8 s / 300 images, PERF.md round 3).
void match_predictions(const float* pred_boxes, const int32_t* pred_cls,
                       int64_t n_pred, const float* gt_boxes,
                       const int32_t* gt_cls, int64_t n_gt,
                       const float* thr, int n_thr, uint8_t* out) {
  memset(out, 0, (size_t)(n_pred * n_thr));
  if (n_pred == 0 || n_gt == 0) return;
  std::vector<float> iou((size_t)(n_gt * n_pred), 0.0f);
  for (int64_t g = 0; g < n_gt; ++g) {
    const float* gb = gt_boxes + g * 4;
    float ga = (gb[2] - gb[0]) * (gb[3] - gb[1]);
    for (int64_t p = 0; p < n_pred; ++p) {
      if (gt_cls[g] != pred_cls[p]) continue;
      const float* pb = pred_boxes + p * 4;
      float x1 = std::max(gb[0], pb[0]), y1 = std::max(gb[1], pb[1]);
      float x2 = std::min(gb[2], pb[2]), y2 = std::min(gb[3], pb[3]);
      float inter = std::max(x2 - x1, 0.0f) * std::max(y2 - y1, 0.0f);
      float pa = (pb[2] - pb[0]) * (pb[3] - pb[1]);
      iou[(size_t)(g * n_pred + p)] = inter / (ga + pa - inter + 1e-7f);
    }
  }
  std::vector<int64_t> order;
  std::vector<uint8_t> seen_gt(n_gt), seen_pred(n_pred);
  for (int t = 0; t < n_thr; ++t) {
    float th = thr[t];
    order.clear();
    for (int64_t i = 0; i < n_gt * n_pred; ++i)
      if (iou[(size_t)i] >= th) order.push_back(i);
    if (order.empty()) continue;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return iou[(size_t)a] > iou[(size_t)b];
    });
    std::fill(seen_gt.begin(), seen_gt.end(), 0);
    std::fill(seen_pred.begin(), seen_pred.end(), 0);
    for (int64_t i : order) {
      int64_t g = i / n_pred, p = i % n_pred;
      if (seen_gt[g] || seen_pred[p]) continue;
      seen_gt[g] = 1;
      seen_pred[p] = 1;
      out[p * n_thr + t] = 1;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native xlsx sheet-XML writer. Sheet-XML generation in Python was the
// dominant cost of the 1M-row split bench (utils/xlsx.py::_sheet_xml —
// per-cell conditional formatting over millions of cells). This emits the
// whole <sheetData> body in one pass from columnar inputs; cell-text
// semantics are byte-identical to the Python writer (inlineStr with
// xml:space for edge whitespace, repr() numbers, t="b" bools).
// ---------------------------------------------------------------------------

#include <string>

namespace xlsxw {

// Python repr() for a finite double: like rewrite::fmt_num but integral
// values keep their ".0" (repr(5.0) == "5.0"; json.dumps(int) semantics in
// fmt_num print "5"). -0.0 reprs as "-0.0".
inline int fmt_repr(double v, char* out) {
  if (v == std::floor(v) && std::fabs(v) < 9007199254740992.0) {  // 2^53
    char* w = out;
    if (std::signbit(v) && v == 0.0) { *w++ = '-'; }
    int n = snprintf(w, 24, "%lld", (long long)v);
    w += n;
    *w++ = '.'; *w++ = '0';
    return (int)(w - out);
  }
  return rewrite::fmt_num(v, out);  // non-integral: identical digit logic
}

inline bool is_ws(char ch) {
  return ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r';
}

// write text with XML escaping (&, <, >, ") — same set the Python writer
// escapes (_xml_escape in utils/xlsx.py). Raw-cursor byte loop: JSON-heavy
// cells escape every ~20 bytes, where segmented std::string appends cost
// more than the copy itself.
inline char* write_escaped(char* w, const char* p, int64_t len) {
  const char* end = p + len;
  for (; p < end; ++p) {
    char ch = *p;
    switch (ch) {
      case '&': memcpy(w, "&amp;", 5); w += 5; break;
      case '<': memcpy(w, "&lt;", 4); w += 4; break;
      case '>': memcpy(w, "&gt;", 4); w += 4; break;
      case '"': memcpy(w, "&quot;", 6); w += 6; break;
      default: *w++ = ch;
    }
  }
  return w;
}

// Upper-bound allocator for the writers: virtual over-reservation is fine
// on Linux (untouched pages cost nothing); nullptr -> caller falls back.
inline char* xw_alloc(size_t bound) { return (char*)malloc(bound); }

#define XW_LIT(w, lit) \
  (memcpy((w), lit, sizeof(lit) - 1), (w) + sizeof(lit) - 1)

}  // namespace xlsxw

extern "C" {

// Emit the full worksheet XML for one sheet. Columns are typed:
//   kind 0 = utf-8 string (blob + offsets[nrows+1], valid mask)
//   kind 1 = float64 (NaN -> empty cell; +-inf -> inlineStr str(v))
//   kind 2 = int64 (valid mask; <v>digits</v>)
//   kind 3 = bool (int64 0/1 values, valid mask; t="b")
//   kind 4 = raw  (blob + offsets: pre-rendered full cell XML, e.g. the
//                  Python fallback for exotic value types)
// header_xml (may be empty) is inserted verbatim before the data rows, which
// number from first_row. The result is heap-allocated into *out (length
// *out_len); free with buf_free.
void sheet_xml(int64_t nrows, int32_t ncols, const uint8_t* col_kind,
               const char* const* col_blob, const int64_t* const* col_off,
               const uint8_t* const* col_valid, const double* const* col_f64,
               const int64_t* const* col_i64, const char* header_xml,
               int64_t header_len, int64_t first_row, char** out,
               int64_t* out_len) {
  static const char kHead[] =
      "<?xml version=\"1.0\" encoding=\"UTF-8\" standalone=\"yes\"?>"
      "<worksheet xmlns=\"http://schemas.openxmlformats.org/spreadsheetml/"
      "2006/main\"><sheetData>";
  static const char kTail[] = "</sheetData></worksheet>";

  // spreadsheet column letters (0 -> A, 26 -> AA)
  std::vector<std::string> letters((size_t)std::max<int32_t>(ncols, 0));
  for (int32_t c = 0; c < ncols; ++c) {
    std::string L;
    int64_t idx = c + 1;
    while (idx > 0) {
      int64_t rem;
      idx -= 1;
      rem = idx % 26;
      idx /= 26;
      L.insert(L.begin(), (char)('A' + rem));
    }
    letters[c] = L;
  }

  // Upper bound: worst-case XML escaping is 6x the string payload; per-cell
  // scaffolding <= 100 B (refs, tags, numbers). Virtual over-reservation —
  // untouched pages are free on Linux.
  size_t bound = sizeof(kHead) + sizeof(kTail) + (size_t)header_len +
                 (size_t)nrows * ((size_t)ncols * 100 + 40) + 64;
  for (int32_t c = 0; c < ncols; ++c)
    if (col_off && col_off[c])
      bound += (size_t)col_off[c][nrows] * (col_kind[c] == 0 ? 6 : 1);
  char* buf = xlsxw::xw_alloc(bound);
  if (!buf) { *out = nullptr; *out_len = -1; return; }
  char* w = buf;

  w = XW_LIT(w, kHead);
  memcpy(w, header_xml, (size_t)header_len); w += header_len;

  char rownum[24];
  for (int64_t r = 0; r < nrows; ++r) {
    int rn_len = snprintf(rownum, sizeof(rownum), "%lld",
                          (long long)(first_row + r));
    w = XW_LIT(w, "<row r=\"");
    memcpy(w, rownum, rn_len); w += rn_len;
    w = XW_LIT(w, "\">");
    for (int32_t c = 0; c < ncols; ++c) {
      const uint8_t* valid = col_valid ? col_valid[c] : nullptr;
      if (valid && !valid[r]) continue;
      const std::string& L = letters[c];
      switch (col_kind[c]) {
        case 0: {  // string -> inlineStr
          const char* blob = col_blob[c];
          int64_t a = col_off[c][r], b = col_off[c][r + 1];
          bool edge_ws =
              (b > a) && (xlsxw::is_ws(blob[a]) || xlsxw::is_ws(blob[b - 1]));
          w = XW_LIT(w, "<c r=\"");
          memcpy(w, L.data(), L.size()); w += L.size();
          memcpy(w, rownum, rn_len); w += rn_len;
          if (edge_ws)
            w = XW_LIT(w, "\" t=\"inlineStr\"><is><t xml:space=\"preserve\">");
          else
            w = XW_LIT(w, "\" t=\"inlineStr\"><is><t>");
          w = xlsxw::write_escaped(w, blob + a, b - a);
          w = XW_LIT(w, "</t></is></c>");
          break;
        }
        case 1: {  // float64
          double v = col_f64[c][r];
          if (std::isnan(v)) break;  // empty cell
          w = XW_LIT(w, "<c r=\"");
          memcpy(w, L.data(), L.size()); w += L.size();
          memcpy(w, rownum, rn_len); w += rn_len;
          if (std::isinf(v)) {  // str(float('inf')) text cell
            w = XW_LIT(w, "\" t=\"inlineStr\"><is><t>");
            if (v > 0) w = XW_LIT(w, "inf"); else w = XW_LIT(w, "-inf");
            w = XW_LIT(w, "</t></is></c>");
            break;
          }
          w = XW_LIT(w, "\"><v>");
          w += xlsxw::fmt_repr(v, w);
          w = XW_LIT(w, "</v></c>");
          break;
        }
        case 2: {  // int64
          w = XW_LIT(w, "<c r=\"");
          memcpy(w, L.data(), L.size()); w += L.size();
          memcpy(w, rownum, rn_len); w += rn_len;
          w = XW_LIT(w, "\"><v>");
          w += snprintf(w, 24, "%lld", (long long)col_i64[c][r]);
          w = XW_LIT(w, "</v></c>");
          break;
        }
        case 3: {  // bool
          w = XW_LIT(w, "<c r=\"");
          memcpy(w, L.data(), L.size()); w += L.size();
          memcpy(w, rownum, rn_len); w += rn_len;
          w = XW_LIT(w, "\" t=\"b\"><v>");
          *w++ = col_i64[c][r] ? '1' : '0';
          w = XW_LIT(w, "</v></c>");
          break;
        }
        case 4: {  // raw pre-rendered cell XML
          int64_t a = col_off[c][r], b = col_off[c][r + 1];
          memcpy(w, col_blob[c] + a, (size_t)(b - a)); w += b - a;
          break;
        }
      }
    }
    w = XW_LIT(w, "</row>");
  }
  w = XW_LIT(w, kTail);

  *out = buf;
  *out_len = (int64_t)(w - buf);
}

void buf_free(char* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native xlsx sheet-XML READER for the SpreadsheetML subset this package
// writes (plus sharedStrings / t="str" cells for foreign files). Python's
// ElementTree cannot even PARSE the 1M-row category workbooks the split
// step emits (expat "out of memory" at ~1.2 GB of sheet XML); this scanner
// streams the part in two passes with O(cells) output. Any construct
// outside the subset aborts cleanly and the caller falls back to the
// ElementTree path.
// ---------------------------------------------------------------------------

namespace xlsxr {

struct Attr {
  const char* val_s;
  int64_t val_len;
};

// Parse XML attributes inside a tag, looking for `name="..."`/'...'.
// p points after the tag name; end at '>' (caller finds it). Returns true
// and fills found if the attribute exists.
inline bool find_attr(const char* p, const char* end, const char* name,
                      Attr* out) {
  size_t nl = strlen(name);
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    const char* ns = p;
    while (p < end && *p != '=' && *p != ' ' && *p != '>' && *p != '/') ++p;
    if (p >= end || *p != '=') return false;  // bare attr / tag end
    const char* ne = p;
    ++p;
    if (p >= end || (*p != '"' && *p != '\'')) return false;
    char q = *p++;
    const char* vs = p;
    while (p < end && *p != q) ++p;
    if (p >= end) return false;
    if ((size_t)(ne - ns) == nl && memcmp(ns, name, nl) == 0) {
      out->val_s = vs;
      out->val_len = p - vs;
      return true;
    }
    ++p;  // past closing quote
  }
  return false;
}

// XML-unescape src into dst (dst sized >= len); returns bytes written or -1
// on an entity the subset doesn't know.
inline int64_t unescape(const char* s, int64_t len, char* dst) {
  const char* end = s + len;
  char* w = dst;
  while (s < end) {
    if (*s != '&') { *w++ = *s++; continue; }
    const char* semi = (const char*)memchr(s, ';', end - s);
    if (!semi) return -1;
    int64_t el = semi - s;
    if (el == 4 && memcmp(s, "&amp", 4) == 0) *w++ = '&';
    else if (el == 3 && memcmp(s, "&lt", 3) == 0) *w++ = '<';
    else if (el == 3 && memcmp(s, "&gt", 3) == 0) *w++ = '>';
    else if (el == 5 && memcmp(s, "&quot", 5) == 0) *w++ = '"';
    else if (el == 5 && memcmp(s, "&apos", 5) == 0) *w++ = '\'';
    else if (el > 2 && s[1] == '#') {
      long cp = (s[2] == 'x' || s[2] == 'X')
                    ? strtol(s + 3, nullptr, 16)
                    : strtol(s + 2, nullptr, 10);
      if (cp <= 0 || cp > 0x10FFFF) return -1;
      // encode UTF-8
      if (cp < 0x80) *w++ = (char)cp;
      else if (cp < 0x800) {
        *w++ = (char)(0xC0 | (cp >> 6));
        *w++ = (char)(0x80 | (cp & 0x3F));
      } else if (cp < 0x10000) {
        *w++ = (char)(0xE0 | (cp >> 12));
        *w++ = (char)(0x80 | ((cp >> 6) & 0x3F));
        *w++ = (char)(0x80 | (cp & 0x3F));
      } else {
        *w++ = (char)(0xF0 | (cp >> 18));
        *w++ = (char)(0x80 | ((cp >> 12) & 0x3F));
        *w++ = (char)(0x80 | ((cp >> 6) & 0x3F));
        *w++ = (char)(0x80 | (cp & 0x3F));
      }
    } else {
      return -1;
    }
    s = semi + 1;
  }
  return w - dst;
}

// cell kinds emitted by sheet_parse
enum { CK_TEXT = 1, CK_NUM = 2, CK_INT = 3, CK_BOOL = 4, CK_SHARED = 5 };

struct Sink {
  // pass 1: counting only
  int64_t n_cells = 0;
  int64_t max_row = -1;
  int64_t max_col = -1;
  int64_t str_bytes = 0;
  // pass 2 outputs (null in pass 1)
  int64_t* cell_row = nullptr;
  int32_t* cell_col = nullptr;
  uint8_t* cell_kind = nullptr;
  double* cell_num = nullptr;
  int64_t* str_off = nullptr;  // per-cell [start, end) into arena
  char* arena = nullptr;
  int64_t arena_pos = 0;
};

// Core scan. Returns 0 ok, -1 unsupported construct.
inline int scan(const char* xml, int64_t len, Sink& k) {
  const char* p = xml;
  const char* end = xml + len;
  const char* sd = nullptr;
  // find <sheetData (reject <sheetData/> empty form handled below)
  for (const char* q = p; q + 10 < end; ++q) {
    if (*q == '<' && memcmp(q + 1, "sheetData", 9) == 0) { sd = q + 10; break; }
  }
  if (!sd) return -1;
  if (*sd == '/')  // <sheetData/>
    return 0;
  if (*sd != '>') return -1;
  p = sd + 1;
  int64_t next_row = 0;
  while (true) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p + 1 >= end) return -1;
    if (*p != '<') return -1;
    if (p[1] == '/') {  // </sheetData>
      return 0;
    }
    if (end - p < 5 || memcmp(p + 1, "row", 3) != 0) return -1;
    const char* tag_end = (const char*)memchr(p, '>', end - p);
    if (!tag_end) return -1;
    Attr a;
    int64_t row;
    if (find_attr(p + 4, tag_end, "r", &a)) {
      row = strtoll(a.val_s, nullptr, 10) - 1;
      if (row < 0) return -1;
    } else {
      row = next_row;
    }
    next_row = row + 1;
    if (row > k.max_row) k.max_row = row;
    bool self_closed = tag_end[-1] == '/';
    p = tag_end + 1;
    if (self_closed) continue;
    int64_t next_col = 0;
    while (true) {  // cells
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
      if (p + 1 >= end) return -1;
      if (*p != '<') return -1;
      if (p[1] == '/') {  // </row>
        const char* te = (const char*)memchr(p, '>', end - p);
        if (!te) return -1;
        p = te + 1;
        break;
      }
      if (end - p < 4 || p[1] != 'c' ||
          (p[2] != ' ' && p[2] != '>' && p[2] != '/'))
        return -1;
      const char* cte = (const char*)memchr(p, '>', end - p);
      if (!cte) return -1;
      int64_t col;
      if (find_attr(p + 2, cte, "r", &a)) {
        col = 0;
        const char* s = a.val_s;
        while (s < a.val_s + a.val_len && *s >= 'A' && *s <= 'Z')
          col = col * 26 + (*s++ - 'A' + 1);
        col -= 1;
        if (col < 0) return -1;
      } else {
        col = next_col;
      }
      next_col = col + 1;
      char ctype = 'n';  // default number
      if (find_attr(p + 2, cte, "t", &a)) {
        if (a.val_len == 9 && memcmp(a.val_s, "inlineStr", 9) == 0) ctype = 'i';
        else if (a.val_len == 1 && *a.val_s == 's') ctype = 'S';
        else if (a.val_len == 1 && *a.val_s == 'b') ctype = 'b';
        else if (a.val_len == 1 && *a.val_s == 'n') ctype = 'n';
        else if (a.val_len == 3 && memcmp(a.val_s, "str", 3) == 0) ctype = 't';
        else return -1;
      }
      if (cte[-1] == '/') { p = cte + 1; continue; }  // empty cell
      p = cte + 1;
      // children until </c>: <v>..</v> and/or <is>..</is>; ignore others?
      bool have_val = false;
      const char* val_s = nullptr;
      int64_t val_len = 0;
      // inline string: possibly multiple <t> runs, concatenated
      int64_t text_total = 0;
      char* text_w = nullptr;  // pass 2: write into arena
      int64_t text_start = k.arena_pos;
      bool have_text = false;
      while (true) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
          ++p;
        if (p + 1 >= end) return -1;
        if (*p != '<') return -1;
        if (p[1] == '/') {  // </c>
          const char* te = (const char*)memchr(p, '>', end - p);
          if (!te) return -1;
          if (te - p != 3 || memcmp(p, "</c", 3) != 0) return -1;
          p = te + 1;
          break;
        }
        if (p[1] == 'v') {  // <v>text</v>
          const char* te = (const char*)memchr(p, '>', end - p);
          if (!te) return -1;
          if (te[-1] == '/') { p = te + 1; have_val = true; val_s = te; val_len = 0; continue; }
          const char* close = te + 1;
          while (close + 3 < end && !(close[0] == '<' && close[1] == '/' &&
                                      close[2] == 'v' && close[3] == '>'))
            ++close;
          if (close + 3 >= end) return -1;
          val_s = te + 1;
          val_len = close - val_s;
          have_val = true;
          p = close + 4;
          continue;
        }
        if (p[1] == 'i' && p + 3 < end && p[2] == 's') {  // <is>
          const char* te = (const char*)memchr(p, '>', end - p);
          if (!te) return -1;
          have_text = true;  // ET joins runs: zero runs still yield ""
          p = te + 1;
          // runs of <t ...>text</t> (and we reject anything else inside)
          while (true) {
            while (p < end &&
                   (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
              ++p;
            if (p + 1 >= end) return -1;
            if (*p != '<') return -1;
            if (p[1] == '/') {  // </is>
              const char* t2 = (const char*)memchr(p, '>', end - p);
              if (!t2) return -1;
              if (t2 - p != 4 || memcmp(p, "</is", 4) != 0) return -1;
              p = t2 + 1;
              break;
            }
            if (end - p < 4 || p[1] != 't' ||
                (p[2] != '>' && p[2] != ' ' && p[2] != '/'))
              return -1;
            const char* t2 = (const char*)memchr(p, '>', end - p);
            if (!t2) return -1;
            have_text = true;
            if (t2[-1] == '/') { p = t2 + 1; continue; }  // <t/>
            const char* close = t2 + 1;
            while (close + 3 < end && !(close[0] == '<' && close[1] == '/' &&
                                        close[2] == 't' && close[3] == '>'))
              ++close;
            if (close + 3 >= end) return -1;
            int64_t raw_len = close - (t2 + 1);
            if (k.arena) {
              text_w = k.arena + k.arena_pos;
              int64_t wl = unescape(t2 + 1, raw_len, text_w);
              if (wl < 0) return -1;
              k.arena_pos += wl;
              text_total += wl;
            } else {
              text_total += raw_len;  // upper bound (unescape only shrinks)
            }
            p = close + 4;
          }
          continue;
        }
        return -1;  // unknown child element
      }
      // classify + emit
      uint8_t kind = 0;
      double num = 0.0;
      int64_t sp_s = 0, sp_e = 0;
      if (ctype == 'i') {
        if (!have_text) continue;  // no runs -> None (ET yields "")? ET joins
        kind = CK_TEXT;
        sp_s = text_start;
        sp_e = k.arena ? k.arena_pos : text_start + text_total;
      } else if (have_val && val_len > 0) {
        if (ctype == 'S') {
          kind = CK_SHARED;
          num = (double)strtoll(val_s, nullptr, 10);
        } else if (ctype == 'b') {
          kind = CK_BOOL;
          num = (val_len == 1 && *val_s == '1') ? 1.0 : 0.0;
        } else if (ctype == 't') {
          kind = CK_TEXT;  // formula string: unescaped text from <v>
          if (k.arena) {
            int64_t wl = unescape(val_s, val_len, k.arena + k.arena_pos);
            if (wl < 0) return -1;
            sp_s = k.arena_pos;
            k.arena_pos += wl;
            sp_e = k.arena_pos;
          } else {
            k.str_bytes += val_len;
            sp_s = sp_e = 0;
          }
        } else {  // number (or non-numeric text stored unquoted)
          // replicate _parse_number: float(text); int when integral and the
          // TEXT has no '.'/'e'; non-parse -> raw text
          char buf[64];
          const char* ts = val_s;
          const char* te2 = val_s + val_len;
          while (ts < te2 && (*ts == ' ' || *ts == '\t' || *ts == '\n' ||
                              *ts == '\r')) ++ts;
          while (te2 > ts && (te2[-1] == ' ' || te2[-1] == '\t' ||
                              te2[-1] == '\n' || te2[-1] == '\r')) --te2;
          int64_t tlen = te2 - ts;
          bool hexish = false;  // strtod accepts 0x1A; Python float() doesn't
          if (tlen > 1) {
            const char* h = ts + ((*ts == '+' || *ts == '-') ? 1 : 0);
            hexish = (h + 1 < te2 && h[0] == '0' && (h[1] == 'x' || h[1] == 'X'));
          }
          if (!hexish && tlen > 0 && tlen < 63) {
            memcpy(buf, ts, tlen);
            buf[tlen] = '\0';
            char* endp = nullptr;
            double v = strtod(buf, &endp);
            if (endp == buf + tlen) {
              bool has_dot = memchr(buf, '.', tlen) ||
                             memchr(buf, 'e', tlen) ||
                             memchr(buf, 'E', tlen);
              if (!has_dot && v == std::floor(v) && !std::isinf(v)) {
                kind = CK_INT;
              } else {
                kind = CK_NUM;
              }
              num = v;
            }
          }
          if (kind == 0) {  // text fallback (incl. >=63-char numerics)
            kind = CK_TEXT;
            if (k.arena) {
              int64_t wl = unescape(val_s, val_len, k.arena + k.arena_pos);
              if (wl < 0) return -1;
              sp_s = k.arena_pos;
              k.arena_pos += wl;
              sp_e = k.arena_pos;
            } else {
              k.str_bytes += val_len;
            }
          }
        }
      } else {
        continue;  // no value -> empty cell
      }
      // count <is> text for ANY cell type: pass 2 unescapes it into the
      // arena before classification, so an <is> inside a t="n" cell must
      // still reserve space (heap overflow otherwise)
      if (!k.arena) k.str_bytes += text_total;
      if (col > k.max_col) k.max_col = col;
      if (k.cell_row) {
        k.cell_row[k.n_cells] = row;
        k.cell_col[k.n_cells] = (int32_t)col;
        k.cell_kind[k.n_cells] = kind;
        k.cell_num[k.n_cells] = num;
        k.str_off[k.n_cells * 2] = sp_s;
        k.str_off[k.n_cells * 2 + 1] = sp_e;
      }
      ++k.n_cells;
    }
  }
}

}  // namespace xlsxr

extern "C" {

// Pass 1: count cells / bound string bytes. Returns 0 ok, -1 unsupported
// (caller falls back to the ElementTree reader).
int sheet_parse_count(const char* xml, int64_t len, int64_t* out_n_cells,
                      int64_t* out_max_row, int64_t* out_max_col,
                      int64_t* out_str_bytes) {
  xlsxr::Sink k;
  int rc = xlsxr::scan(xml, len, k);
  if (rc != 0) return -1;
  *out_n_cells = k.n_cells;
  *out_max_row = k.max_row;
  *out_max_col = k.max_col;
  *out_str_bytes = k.str_bytes;
  return 0;
}

// Pass 2: fill cell arrays (sized from pass 1).
int sheet_parse_fill(const char* xml, int64_t len, int64_t* cell_row,
                     int32_t* cell_col, uint8_t* cell_kind, double* cell_num,
                     int64_t* str_off, char* arena, int64_t* out_n_cells,
                     int64_t* out_arena_len) {
  xlsxr::Sink k;
  k.cell_row = cell_row;
  k.cell_col = cell_col;
  k.cell_kind = cell_kind;
  k.cell_num = cell_num;
  k.str_off = str_off;
  k.arena = arena;
  int rc = xlsxr::scan(xml, len, k);
  if (rc != 0) return -1;
  *out_n_cells = k.n_cells;
  *out_arena_len = k.arena_pos;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native CSV writer: byte-identical to pandas ``df.to_csv(path, index=False)``
// on the dtypes the datakit moves (str / float64 / int64 / bool). QUOTE_
// MINIMAL semantics: a field quotes iff it contains ',', '"', '\n' or '\r'
// (quotechar doubles inside); NaN/null -> empty; floats print as repr();
// a single-column table writes an empty field as "" (csv-module blank-line
// disambiguation). Column typing mirrors sheet_xml's kinds 0-3.
// ---------------------------------------------------------------------------

namespace csvw {

inline bool needs_quote(const char* p, int64_t len) {
  for (int64_t i = 0; i < len; ++i) {
    char ch = p[i];
    if (ch == ',' || ch == '"' || ch == '\n' || ch == '\r') return true;
  }
  return false;
}

// raw-cursor field writer: unquoted fields memcpy straight through; quoted
// fields copy byte-wise doubling '"' (JSON cells quote every ~20 bytes —
// segmented appends cost more than the copy)
inline char* write_field(char* w, const char* p, int64_t len) {
  if (!needs_quote(p, len)) {
    memcpy(w, p, (size_t)len);
    return w + len;
  }
  *w++ = '"';
  const char* end = p + len;
  for (; p < end; ++p) {
    char ch = *p;
    *w++ = ch;
    if (ch == '"') *w++ = '"';
  }
  *w++ = '"';
  return w;
}

}  // namespace csvw

extern "C" {

// Emit the CSV body (no BOM; header_bytes prepends verbatim). Columns are
// typed as in sheet_xml: 0 str (blob+offsets+valid), 1 float64, 2 int64,
// 3 bool (int64 0/1 + valid), 5 mixed int/float object column (valid acts
// as a 3-state tag: 0 empty, 1 int from col_i64, 2 float from col_f64 —
// the datakit's width/height columns keep per-cell int-ness). Result
// buffer: free with buf_free.
void csv_write(int64_t nrows, int32_t ncols, const uint8_t* col_kind,
               const char* const* col_blob, const int64_t* const* col_off,
               const uint8_t* const* col_valid, const double* const* col_f64,
               const int64_t* const* col_i64, const char* header_bytes,
               int64_t header_len, char** out, int64_t* out_len) {
  // Upper bound: worst-case quoting doubles the payload (+2 quotes); numbers
  // <= 34 B/cell. Virtual over-reservation; nullptr -> Python falls back.
  size_t bound = (size_t)header_len +
                 (size_t)nrows * ((size_t)ncols * 40 + 4) + 64;
  for (int32_t c = 0; c < ncols; ++c)
    if (col_off && col_off[c]) bound += (size_t)col_off[c][nrows] * 2;
  char* buf = xlsxw::xw_alloc(bound);
  if (!buf) { *out = nullptr; *out_len = -1; return; }
  char* w = buf;
  memcpy(w, header_bytes, (size_t)header_len); w += header_len;

  for (int64_t r = 0; r < nrows; ++r) {
    for (int32_t c = 0; c < ncols; ++c) {
      if (c) *w++ = ',';
      const uint8_t* valid = col_valid ? col_valid[c] : nullptr;
      bool empty = false;
      if (col_kind[c] == 5) {  // mixed numeric: valid is the 3-state tag
        uint8_t tag = valid[r];
        if (tag == 0) {
          empty = true;
        } else if (tag == 1) {
          w += snprintf(w, 24, "%lld", (long long)col_i64[c][r]);
        } else {
          double v = col_f64[c][r];
          if (std::isnan(v)) empty = true;
          else if (std::isinf(v)) { if (v < 0) *w++ = '-'; w = XW_LIT(w, "inf"); }
          else w += xlsxw::fmt_repr(v, w);
        }
      } else if (valid && !valid[r]) {
        empty = true;
      } else {
        switch (col_kind[c]) {
          case 0: {  // str
            int64_t a = col_off[c][r], b = col_off[c][r + 1];
            if (b == a) { empty = true; break; }
            w = csvw::write_field(w, col_blob[c] + a, b - a);
            break;
          }
          case 1: {  // float64: repr(); NaN -> empty; inf -> str(inf)
            double v = col_f64[c][r];
            if (std::isnan(v)) { empty = true; break; }
            if (std::isinf(v)) { if (v < 0) *w++ = '-'; w = XW_LIT(w, "inf"); break; }
            w += xlsxw::fmt_repr(v, w);
            break;
          }
          case 2:  // int64
            w += snprintf(w, 24, "%lld", (long long)col_i64[c][r]);
            break;
          case 3:  // bool
            if (col_i64[c][r]) w = XW_LIT(w, "True"); else w = XW_LIT(w, "False");
            break;
        }
      }
      if (empty && ncols == 1) w = XW_LIT(w, "\"\"");
    }
    *w++ = '\n';
  }

  *out = buf;
  *out_len = (int64_t)(w - buf);
}

}  // extern "C"
