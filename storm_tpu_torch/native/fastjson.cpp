// Fast {"instances": [[[[...]]]]} JSON parser -> contiguous float32 buffer,
// and the {"predictions": [[...]]} writer: storm_tpu_torch's copy of
// storm_tpu/native/fastjson.cpp, the same code, so the port parses and
// writes the reference's exact bytes and floats.
//
// One pass over the payload bytes, floats decoded straight into a single
// contiguous buffer that the Python side copies into one NumPy array
// (storm_tpu_torch/native/__init__.py), ready for a single host->device
// transfer.
//
// Contract (mirrors storm_tpu_torch.api.schema.decode_instances):
//   - top-level object must contain an "instances" key; other keys are
//     skipped structurally;
//   - value must be a rectangular nested array, max rank 8; raggedness,
//     non-numeric leaves, empty dims and malformed JSON are errors;
//   - returns a malloc'd float buffer (caller frees via stpu_free) and the
//     shape/rank via out-params; on error returns nullptr with a
//     thread-local message in *err_out.
//
// Built at first use by storm_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC), cached by a hash of this file.

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxRank = 8;

thread_local std::string g_err;

struct Parser {
  const char* p;
  const char* end;
  std::vector<float> out;
  int64_t shape[kMaxRank];
  int rank = -1;  // set on first full descent

  explicit Parser(const char* buf, size_t len) : p(buf), end(buf + len) {
    for (int64_t& s : shape) s = -1;
    // ~7 bytes per "0.1234," literal: one reserve sized off the payload
    // avoids every growth-realloc copy of the output buffer.
    out.reserve(len / 6 + 16);
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool fail(const std::string& msg) {
    g_err = msg;
    return false;
  }

  bool expect(char c) {
    skip_ws();
    if (p >= end || *p != c) return fail(std::string("expected '") + c + "'");
    ++p;
    return true;
  }

  // Parse a JSON string (only used for keys; escapes are skipped, not decoded).
  bool parse_string(std::string* s) {
    skip_ws();
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    const char* start = p;
    while (p < end) {
      if (*p == '\\') {
        p += 2;
        continue;
      }
      if (*p == '"') {
        if (s) s->assign(start, p - start);
        ++p;
        return true;
      }
      ++p;
    }
    return fail("unterminated string");
  }

  // Structurally skip any JSON value (for non-"instances" keys).
  bool skip_value() {
    skip_ws();
    if (p >= end) return fail("unexpected end of input");
    char c = *p;
    if (c == '"') return parse_string(nullptr);
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      while (p < end) {
        if (*p == '"') {
          if (!parse_string(nullptr)) return false;
          continue;
        }
        if (*p == open) ++depth;
        if (*p == close && --depth == 0) {
          ++p;
          return true;
        }
        ++p;
      }
      return fail("unterminated container");
    }
    // number / literal: consume until delimiter
    while (p < end && *p != ',' && *p != '}' && *p != ']' &&
           !std::isspace(static_cast<unsigned char>(*p)))
      ++p;
    return true;
  }

  // Fixed-point decimal fast path: sign, <=15 digits, optional '.', no
  // exponent — covers pixel/probability literals. The <=15-digit mantissa is
  // exact in a uint64->double, and negative powers of ten up to 1e15 are
  // exact doubles, so one double divide + one float cast is correctly
  // rounded to within 1 ulp of from_chars (which remains the fallback).
  bool parse_float_fast(float* out_v) {
    static constexpr double kPow10[16] = {
        1e0, 1e1, 1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
        1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};
    const char* q = p;
    bool neg = false;
    if (q < end && *q == '-') {
      neg = true;
      ++q;
    }
    uint64_t mant = 0;
    int digits = 0;
    while (q < end && static_cast<unsigned>(*q - '0') <= 9) {
      mant = mant * 10 + static_cast<unsigned>(*q - '0');
      ++q;
      ++digits;
    }
    int frac = 0;
    if (q < end && *q == '.') {
      ++q;
      const char* fs = q;
      while (q < end && static_cast<unsigned>(*q - '0') <= 9) {
        mant = mant * 10 + static_cast<unsigned>(*q - '0');
        ++q;
      }
      frac = static_cast<int>(q - fs);
      digits += frac;
    }
    if (digits == 0 || digits > 15 || frac > 15) return false;
    if (q < end && (*q == 'e' || *q == 'E')) return false;
    double d = static_cast<double>(mant);
    if (frac) d /= kPow10[frac];
    *out_v = static_cast<float>(neg ? -d : d);
    p = q;
    return true;
  }

  // Tight loop for the innermost dimension: numbers only, no per-element
  // recursion or depth checks — this is where ~all the bytes are.
  bool parse_leaf_array(int depth, int64_t* count) {
    int64_t n = 0;
    while (true) {
      skip_ws();
      if (p >= end) return fail("unterminated array");
      if (*p == '[') return fail("instances is ragged (mixed nesting depth)");
      float v;
      if (!parse_float_fast(&v)) {
        auto res = std::from_chars(p, end, v);
        if (res.ec != std::errc())
          return fail("instances contains a non-numeric leaf");
        p = res.ptr;
      }
      out.push_back(v);
      ++n;
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == ']') {
        ++p;
        break;
      }
      return fail("expected ',' or ']' in array");
    }
    if (shape[depth] == -1) {
      shape[depth] = n;
    } else if (shape[depth] != n) {
      return fail("instances is ragged (inconsistent lengths)");
    }
    *count = n;
    return true;
  }

  // Parse the nested array at `depth`; returns element count via *count.
  bool parse_array(int depth, int64_t* count) {
    if (depth >= kMaxRank) return fail("instances exceeds max rank 8");
    if (!expect('[')) return false;
    skip_ws();
    if (p < end && *p == ']') {
      ++p;
      return fail("instances has an empty dimension");
    }
    if (depth == rank - 1) return parse_leaf_array(depth, count);
    int64_t n = 0;
    while (true) {
      skip_ws();
      if (p >= end) return fail("unterminated array");
      if (*p == '[') {
        int64_t sub = 0;
        if (!parse_array(depth + 1, &sub)) return false;
      } else {
        return fail("instances is ragged (mixed nesting depth)");
      }
      ++n;
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == ']') {
        ++p;
        break;
      }
      return fail("expected ',' or ']' in array");
    }
    if (shape[depth] == -1) {
      shape[depth] = n;
    } else if (shape[depth] != n) {
      return fail("instances is ragged (inconsistent lengths)");
    }
    *count = n;
    return true;
  }

  bool parse_instances_value() {
    skip_ws();
    if (p >= end || *p != '[')
      return fail("\"instances\" must be a nested array");
    // First, probe nesting depth to fix the rank (scan leading '[').
    const char* q = p;
    int depth = 0;
    while (q < end) {
      if (*q == '[') {
        ++depth;
        ++q;
        continue;
      }
      if (std::isspace(static_cast<unsigned char>(*q))) {
        ++q;
        continue;
      }
      break;
    }
    if (depth == 0 || depth > kMaxRank) return fail("bad instances nesting");
    rank = depth;
    int64_t n = 0;
    return parse_array(0, &n);
  }

  bool parse_document() {
    skip_ws();
    if (!expect('{')) return fail("payload is not a JSON object");
    bool found = false;
    skip_ws();
    if (p < end && *p == '}') return fail("payload missing \"instances\" key");
    while (true) {
      std::string key;
      if (!parse_string(&key)) return false;
      if (!expect(':')) return false;
      if (key == "instances") {
        if (!parse_instances_value()) return false;
        found = true;
      } else {
        if (!skip_value()) return false;
      }
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        skip_ws();
        continue;
      }
      if (p < end && *p == '}') {
        ++p;
        break;
      }
      return fail("expected ',' or '}' in object");
    }
    if (!found) return fail("payload missing \"instances\" key");
    skip_ws();
    if (p != end) return fail("trailing bytes after JSON document");
    return true;
  }
};

}  // namespace

extern "C" {

// Returns a malloc'd float32 buffer (or nullptr on error; *err_out then
// points at a thread-local message). Caller frees with stpu_free.
float* stpu_parse_instances(const char* buf, size_t len, int64_t* shape_out,
                            int32_t* rank_out, const char** err_out) {
  Parser parser(buf, len);
  if (!parser.parse_document()) {
    if (err_out) *err_out = g_err.c_str();
    return nullptr;
  }
  int rank = parser.rank;
  int64_t expected = 1;
  for (int i = 0; i < rank; ++i) expected *= parser.shape[i];
  if (expected != static_cast<int64_t>(parser.out.size())) {
    g_err = "instances is ragged (element count mismatch)";
    if (err_out) *err_out = g_err.c_str();
    return nullptr;
  }
  float* result =
      static_cast<float*>(std::malloc(parser.out.size() * sizeof(float)));
  if (!result) {
    g_err = "out of memory";
    if (err_out) *err_out = g_err.c_str();
    return nullptr;
  }
  std::memcpy(result, parser.out.data(), parser.out.size() * sizeof(float));
  for (int i = 0; i < rank; ++i) shape_out[i] = parser.shape[i];
  *rank_out = rank;
  return result;
}

void stpu_free(void* p) { std::free(p); }

// Serialize an (n, k) float32 matrix to the {"predictions": [[...]]} wire
// form (PredObj.java:9-17 equivalent). Numbers are rounded to 7 decimal
// places then printed with shortest round-trip (std::to_chars), matching the
// Python path's json.dumps(round(float64, 7)) to within the rounding-mode
// ulp. Returns a malloc'd buffer (caller frees via stpu_free); *len_out gets
// the byte length. Non-finite values are emitted as JSON-python tokens
// (NaN/Infinity), mirroring json.dumps defaults.
char* stpu_format_predictions(const float* data, int64_t n, int64_t k,
                              size_t* len_out) {
  std::string s;
  s.reserve(static_cast<size_t>(n * k) * 12 + 24);
  s += "{\"predictions\": [";
  char buf[32];
  for (int64_t i = 0; i < n; ++i) {
    s += (i ? ", [" : "[");
    for (int64_t j = 0; j < k; ++j) {
      if (j) s += ", ";
      double v = static_cast<double>(data[i * k + j]);
      if (v != v) {
        s += "NaN";
        continue;
      }
      if (v > 1.7e308 || v < -1.7e308) {
        s += (v > 0 ? "Infinity" : "-Infinity");
        continue;
      }
      double r = std::round(v * 1e7) / 1e7;
      auto res = std::to_chars(buf, buf + sizeof(buf), r);
      s.append(buf, res.ptr - buf);
    }
    s += "]";
  }
  s += "]}";
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (!out) return nullptr;
  std::memcpy(out, s.data(), s.size() + 1);
  *len_out = s.size();
  return out;
}

}  // extern "C"
