// Arrow IPC tensor marshalling, no external dependencies: storm_tpu_torch's
// copy of storm_tpu/native/arrow_tensor.cpp. The flatbuffer builder, the
// encoder and stpu_tensor_decode are that file's code, so the port writes
// the reference's bytes and views the layouts it views. Two changes, both
// for what storm_tpu hands to pyarrow (which the machine with the card
// does not have):
//
//   - stpu_tensor_encode takes ranks 1..kMaxRank (32) instead of 1..8;
//     the metadata it writes for ranks 9..32 is pyarrow's write_tensor
//     byte for byte, as it is for 1..8;
//   - stpu_tensor_decode_layout, new, reads what stpu_tensor_decode
//     declines as "valid Arrow, not viewable raw" (rc 100): any rank up to
//     kMaxRank (rank 0 included) and any non-negative strides, reported
//     so that numpy can view the body as pyarrow's Tensor.to_numpy does.
//     An element type numpy cannot view (an Int of another width, a
//     non-numeric type) is reported, not read.
//
// Encapsulated message layout (Arrow format docs):
//   [FFFFFFFF][int32 metadata_len][flatbuffer, padded][body]
// with the body 64-byte aligned from message start (matching pyarrow) and
// Buffer{offset,length} in the metadata locating the tensor bytes, so the
// decode side can hand back a pointer INTO the received buffer — zero-copy.
//
// The flatbuffer builder below is the minimal general mechanism: buffers
// build back-to-front; `pos` is the offset-from-end of an object's start;
// a uoffset field at pos P referring to target T stores P - T; a table's
// soffset stores pos(vtable) - pos(table); vtable slots store
// pos(table) - pos(field).
//
// Built with fastjson.cpp (where stpu_free lives) into one library by
// storm_tpu_torch/native/__init__.py at first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// Minimal flatbuffer builder (back-to-front)
// ---------------------------------------------------------------------------

constexpr size_t kFbCap = 4096;  // metadata for ndim<=32 fits in under 2K
constexpr int kMaxRank = 32;

struct FB {
  uint8_t buf[kFbCap];
  size_t head = kFbCap;  // index of first used byte; decreases as we write

  size_t pos() const { return kFbCap - head; }

  // Pad so that a `size`-byte scalar written after `additional` more bytes
  // lands aligned to `size` (same contract as the reference builders' Prep).
  void prep(size_t size, size_t additional = 0) {
    size_t used = pos() + additional;
    size_t pad = (~used + 1) & (size - 1);
    head -= pad;
    std::memset(buf + head, 0, pad);
  }

  template <typename T>
  void push(T v) {
    prep(sizeof(T));
    head -= sizeof(T);
    std::memcpy(buf + head, &v, sizeof(T));
  }

  // Write a uoffset (u32) pointing at an object whose pos() was `target`.
  void push_uoffset(size_t target) {
    prep(4);
    head -= 4;
    uint32_t v = static_cast<uint32_t>(pos() - target);
    std::memcpy(buf + head, &v, 4);
  }

  // Vector of int64 (e.g. strides). Returns vector pos (points at count).
  size_t vec_i64(const int64_t* vals, size_t n) {
    prep(4, 8 * n);
    prep(8, 8 * n);
    for (size_t i = n; i-- > 0;) {
      head -= 8;
      std::memcpy(buf + head, &vals[i], 8);
    }
    push<uint32_t>(static_cast<uint32_t>(n));
    return pos();
  }

  // Vector of table offsets (e.g. shape: [TensorDim]).
  size_t vec_offsets(const size_t* targets, size_t n) {
    prep(4, 4 * n);
    for (size_t i = n; i-- > 0;) push_uoffset(targets[i]);
    push<uint32_t>(static_cast<uint32_t>(n));
    return pos();
  }

  // --- table construction -------------------------------------------------
  // Usage: write fields (any order), recording slots; then end_table().
  struct Slot {
    uint16_t off = 0;  // pos(table) - pos(field); patched in end_table
    size_t field_pos = 0;
    uint8_t size = 0;
    bool present = false;
  };
  Slot slots[8];
  int nslots = 0;

  void start_table(int n) {
    nslots = n;
    for (int i = 0; i < n; i++) slots[i] = Slot{};
  }

  template <typename T>
  void field_scalar(int slot, T v) {
    push<T>(v);
    slots[slot] = {0, pos(), sizeof(T), true};
  }

  void field_offset(int slot, size_t target) {
    push_uoffset(target);
    slots[slot] = {0, pos(), 4, true};
  }

  // Inline struct (e.g. Buffer{offset,length}), `align`-aligned.
  void field_struct(int slot, const void* bytes, size_t size, size_t align) {
    prep(align, 0);
    head -= size;
    std::memcpy(buf + head, bytes, size);
    slots[slot] = {0, pos(), static_cast<uint8_t>(size), true};
  }

  size_t end_table() {
    // soffset placeholder at the table start
    prep(4);
    head -= 4;
    size_t table_pos = pos();
    size_t table_idx = head;
    uint16_t table_size = 4;
    for (int i = 0; i < nslots; i++) {
      if (!slots[i].present) continue;
      slots[i].off = static_cast<uint16_t>(table_pos - slots[i].field_pos);
      uint16_t end = slots[i].off + slots[i].size;
      if (end > table_size) table_size = end;
    }
    // vtable (after the table in write order => lower address side)
    prep(2, 2 * nslots + 4);
    for (int i = nslots; i-- > 0;) {
      head -= 2;
      std::memcpy(buf + head, &slots[i].off, 2);
    }
    push<uint16_t>(table_size);
    push<uint16_t>(static_cast<uint16_t>(4 + 2 * nslots));
    size_t vt_pos = pos();
    int32_t soffset = static_cast<int32_t>(vt_pos - table_pos);
    std::memcpy(buf + table_idx, &soffset, 4);
    return table_pos;
  }

  // Finish with the root uoffset; returns the start index. Pads so the
  // total flatbuffer length is 8-aligned (min_align: we store int64 fields,
  // whose in-buffer alignment is relative to the buffer END).
  size_t finish(size_t root) {
    prep(8, 4);
    push_uoffset(root);
    return head;
  }
};

// Dtype codes shared with Python (storm_tpu_torch/native/__init__.py).
enum DType {
  DT_F32 = 0, DT_F64 = 1, DT_F16 = 2,
  DT_U8 = 3, DT_I8 = 4, DT_U16 = 5, DT_I16 = 6,
  DT_U32 = 7, DT_I32 = 8, DT_U64 = 9, DT_I64 = 10,
};

int dtype_itemsize(int dt) {
  switch (dt) {
    case DT_U8: case DT_I8: return 1;
    case DT_F16: case DT_U16: case DT_I16: return 2;
    case DT_F32: case DT_U32: case DT_I32: return 4;
    default: return 8;
  }
}

// Arrow flatbuffer enum values (format/Schema.fbs, format/Message.fbs).
constexpr uint8_t kTypeInt = 2;            // union Type.Int
constexpr uint8_t kTypeFloatingPoint = 3;  // union Type.FloatingPoint
constexpr uint8_t kHeaderTensor = 4;       // union MessageHeader.Tensor
constexpr int16_t kMetadataV5 = 4;
constexpr int16_t kPrecisionHalf = 0, kPrecisionSingle = 1, kPrecisionDouble = 2;

// ---------------------------------------------------------------------------
// Flatbuffer reader helpers
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* fb;
  size_t len;

  template <typename T>
  bool rd(size_t off, T* out) const {
    if (off + sizeof(T) > len) return false;
    std::memcpy(out, fb + off, sizeof(T));
    return true;
  }

  // Absolute offset of table field `slot`, or 0 if absent/out of range.
  size_t field(size_t table, int slot) const {
    int32_t soff;
    if (!rd(table, &soff)) return 0;
    size_t vt = static_cast<size_t>(static_cast<int64_t>(table) - soff);
    uint16_t vt_size;
    if (!rd(vt, &vt_size)) return 0;
    size_t slot_off = 4 + 2 * static_cast<size_t>(slot);
    if (slot_off + 2 > vt_size) return 0;
    uint16_t foff;
    if (!rd(vt + slot_off, &foff)) return 0;
    return foff ? table + foff : 0;
  }

  // Follow a uoffset stored at `at`.
  size_t indirect(size_t at) const {
    uint32_t u;
    if (!rd(at, &u)) return 0;
    return at + u;
  }
};

}  // namespace

extern "C" {

void stpu_free(void* p);  // fastjson.cpp

// Encode `data` (C-contiguous, dtype code `dtype`, shape `shape[ndim]`) as a
// full Arrow IPC tensor message. Returns a malloc'd buffer (caller frees via
// stpu_free); *out_len receives its length. NULL on bad args.
uint8_t* stpu_tensor_encode(const void* data, int dtype, int ndim,
                            const int64_t* shape, size_t* out_len) {
  if (dtype < 0 || dtype > DT_I64 || ndim < 1 || ndim > kMaxRank || !data || !shape)
    return nullptr;
  int64_t itemsize = dtype_itemsize(dtype);
  int64_t nelem = 1;
  for (int i = 0; i < ndim; i++) {
    if (shape[i] < 0) return nullptr;
    nelem *= shape[i];
  }
  int64_t body_len = nelem * itemsize;

  FB fb;

  // Type table: Int{bitWidth,is_signed} or FloatingPoint{precision}.
  size_t type_tbl;
  uint8_t type_type;
  if (dtype == DT_F16 || dtype == DT_F32 || dtype == DT_F64) {
    type_type = kTypeFloatingPoint;
    int16_t prec = dtype == DT_F16   ? kPrecisionHalf
                   : dtype == DT_F32 ? kPrecisionSingle
                                     : kPrecisionDouble;
    fb.start_table(1);
    fb.field_scalar<int16_t>(0, prec);
    type_tbl = fb.end_table();
  } else {
    type_type = kTypeInt;
    bool is_signed = dtype == DT_I8 || dtype == DT_I16 || dtype == DT_I32 ||
                     dtype == DT_I64;
    fb.start_table(2);
    fb.field_scalar<uint8_t>(1, is_signed ? 1 : 0);
    fb.field_scalar<int32_t>(0, static_cast<int32_t>(8 * itemsize));
    type_tbl = fb.end_table();
  }

  // shape: [TensorDim{size}]  (name omitted — optional field)
  size_t dims[kMaxRank];
  for (int i = 0; i < ndim; i++) {
    fb.start_table(2);
    fb.field_scalar<int64_t>(0, shape[i]);
    dims[i] = fb.end_table();
  }
  size_t shape_vec = fb.vec_offsets(dims, ndim);

  // strides (bytes, row-major contiguous) — pyarrow writes them, so do we.
  int64_t strides[kMaxRank];
  int64_t acc = itemsize;
  for (int i = ndim; i-- > 0;) {
    strides[i] = acc;
    acc *= shape[i];
  }
  size_t strides_vec = fb.vec_i64(strides, ndim);

  // Tensor table: type_type(0), type(1), shape(2), strides(3), data(4)
  int64_t buffer_struct[2] = {0, body_len};  // Buffer{offset,length}
  fb.start_table(5);
  fb.field_struct(4, buffer_struct, 16, 8);
  fb.field_offset(3, strides_vec);
  fb.field_offset(2, shape_vec);
  fb.field_offset(1, type_tbl);
  fb.field_scalar<uint8_t>(0, type_type);
  size_t tensor_tbl = fb.end_table();

  // Message table: version(0), header_type(1), header(2), bodyLength(3)
  fb.start_table(4);
  fb.field_scalar<int64_t>(3, body_len);
  fb.field_offset(2, tensor_tbl);
  fb.field_scalar<uint8_t>(1, kHeaderTensor);
  fb.field_scalar<int16_t>(0, kMetadataV5);
  size_t msg_tbl = fb.end_table();

  size_t start = fb.finish(msg_tbl);
  size_t fb_len = kFbCap - start;

  // Pad metadata so the body starts 64-aligned from message start (pyarrow
  // convention; readers only require the metadata_len bookkeeping).
  size_t meta_len = (8 + fb_len + 63) & ~size_t{63};
  meta_len -= 8;
  size_t total = 8 + meta_len + static_cast<size_t>(body_len);

  uint8_t* out = static_cast<uint8_t*>(std::malloc(total));
  if (!out) return nullptr;
  uint32_t cont = 0xFFFFFFFFu;
  std::memcpy(out, &cont, 4);
  int32_t ml = static_cast<int32_t>(meta_len);
  std::memcpy(out + 4, &ml, 4);
  std::memcpy(out + 8, fb.buf + start, fb_len);
  std::memset(out + 8 + fb_len, 0, meta_len - fb_len);
  std::memcpy(out + 8 + meta_len, data, static_cast<size_t>(body_len));
  *out_len = total;
  return out;
}

// Parse an Arrow IPC tensor message. On success returns 0 and fills dtype,
// ndim, shape[8], body_off/body_len (byte range of the tensor data INSIDE
// `buf` — the caller can view it zero-copy). Nonzero on malformed input,
// non-tensor messages, or non-contiguous strides.
int stpu_tensor_decode(const uint8_t* buf, size_t len, int* dtype, int* ndim,
                       int64_t* shape, size_t* body_off, size_t* body_len) {
  if (!buf || len < 16) return 1;
  uint32_t cont;
  std::memcpy(&cont, buf, 4);
  size_t meta_at = 4;
  if (cont != 0xFFFFFFFFu) {
    // pre-0.15 framing: no continuation marker, metadata length first
    meta_at = 0;
  }
  int32_t meta_len;
  std::memcpy(&meta_len, buf + meta_at, 4);
  size_t fb_start = meta_at + 4;
  if (meta_len <= 0 || fb_start + static_cast<size_t>(meta_len) > len) return 2;
  Reader r{buf + fb_start, static_cast<size_t>(meta_len)};

  size_t root = r.indirect(0);
  if (!root) return 3;
  uint8_t header_type = 0;
  size_t f = r.field(root, 1);
  if (!f || !r.rd(f, &header_type) || header_type != kHeaderTensor) return 4;
  f = r.field(root, 2);
  if (!f) return 5;
  size_t tensor = r.indirect(f);
  int64_t body_length = 0;
  f = r.field(root, 3);
  if (f) r.rd(f, &body_length);

  // Tensor.type
  uint8_t type_type = 0;
  f = r.field(tensor, 0);
  if (!f || !r.rd(f, &type_type)) return 6;
  f = r.field(tensor, 1);
  if (!f) return 6;
  size_t type_tbl = r.indirect(f);
  int dt;
  if (type_type == kTypeFloatingPoint) {
    // Omitted field means the schema default (0 = HALF), not SINGLE.
    int16_t prec = kPrecisionHalf;
    f = r.field(type_tbl, 0);
    if (f) r.rd(f, &prec);
    dt = prec == kPrecisionHalf ? DT_F16 : prec == kPrecisionDouble ? DT_F64 : DT_F32;
  } else if (type_type == kTypeInt) {
    int32_t bits = 0;
    uint8_t is_signed = 0;
    f = r.field(type_tbl, 0);
    if (f) r.rd(f, &bits);
    f = r.field(type_tbl, 1);
    if (f) r.rd(f, &is_signed);
    switch (bits) {
      case 8: dt = is_signed ? DT_I8 : DT_U8; break;
      case 16: dt = is_signed ? DT_I16 : DT_U16; break;
      case 32: dt = is_signed ? DT_I32 : DT_U32; break;
      case 64: dt = is_signed ? DT_I64 : DT_U64; break;
      default: return 100;  // valid Arrow, not viewable raw -> fall back
    }
  } else {
    return 100;  // unsupported element type (e.g. Decimal) -> fall back
  }
  int64_t itemsize = dtype_itemsize(dt);

  // Tensor.shape
  f = r.field(tensor, 2);
  if (!f) return 8;
  size_t shape_vec = r.indirect(f);
  uint32_t n;
  if (!r.rd(shape_vec, &n)) return 8;
  // Rank 0 or >8 is valid Arrow but outside this fast path's shape buffer —
  // signal fallback, not corruption.
  if (n < 1 || n > 8) return 100;
  int64_t nelem = 1;
  for (uint32_t i = 0; i < n; i++) {
    size_t dim_tbl = r.indirect(shape_vec + 4 + 4 * i);
    if (!dim_tbl) return 8;
    int64_t sz = 0;
    size_t sf = r.field(dim_tbl, 0);
    if (sf) r.rd(sf, &sz);
    if (sz < 0) return 8;
    shape[i] = sz;
    // Adversarial metadata must not overflow nelem*itemsize into a "valid"
    // body range (the decode output is a raw view over the buffer).
    if (__builtin_mul_overflow(nelem, sz, &nelem)) return 8;
  }
  int64_t nbytes;
  if (__builtin_mul_overflow(nelem, itemsize, &nbytes)) return 8;

  // Tensor.strides — the body is handed back as a raw view, so only
  // C-contiguous layouts are supported. Valid-but-unsupported layouts
  // (e.g. Fortran order) return the distinct STPU_TENSOR_UNSUPPORTED so the
  // caller can fall back to a general reader rather than reject the message.
  f = r.field(tensor, 3);
  if (f) {
    size_t sv = r.indirect(f);
    uint32_t sn;
    if (!r.rd(sv, &sn) || sn != n) return 9;
    int64_t acc = itemsize;
    for (uint32_t i = n; i-- > 0;) {
      int64_t got;
      if (!r.rd(sv + 4 + 8 * i, &got)) return 9;
      if (shape[i] > 1 && got != acc) return 100;  // STPU_TENSOR_UNSUPPORTED
      acc *= shape[i];
    }
  }

  // Tensor.data: Buffer{offset,length} struct, relative to body start.
  f = r.field(tensor, 4);
  if (!f) return 10;
  int64_t buf_off, buf_len;
  if (!r.rd(f, &buf_off) || !r.rd(f + 8, &buf_len)) return 10;
  if (buf_off < 0 || buf_len < nbytes) return 10;
  // The data range must sit inside the declared message body too, not just
  // inside the raw buffer (a writer's Buffer and bodyLength must agree).
  if (body_length > 0 &&
      (buf_off > body_length || buf_len > body_length - buf_off))
    return 10;
  size_t body_start = fb_start + static_cast<size_t>(meta_len);
  size_t off = body_start + static_cast<size_t>(buf_off);
  if (off > len || static_cast<size_t>(nbytes) > len - off) return 11;

  *dtype = dt;
  *ndim = static_cast<int>(n);
  *body_off = off;
  *body_len = static_cast<size_t>(nbytes);
  return 0;
}


// The layouts stpu_tensor_decode answers with rc 100, read as pyarrow's
// read_tensor + Tensor.to_numpy read them. On 0 fills dtype, ndim (0..32),
// shape[kMaxRank], strides[kMaxRank] (bytes, as the message states them,
// or row-major when it states none), data_off (the first element's byte
// INSIDE `buf`) and data_span (the bytes the strides reach). Returns 100
// with *type_type and *bit_width set for an element type numpy cannot
// view, 101 for a rank above kMaxRank, 102 for a negative stride; other
// codes, as in stpu_tensor_decode, for malformed input.
int stpu_tensor_decode_layout(const uint8_t* buf, size_t len, int* dtype,
                              int* ndim, int64_t* shape, int64_t* strides,
                              size_t* data_off, size_t* data_span,
                              int* type_type_out, int* bit_width_out) {
  if (!buf || len < 16) return 1;
  uint32_t cont;
  std::memcpy(&cont, buf, 4);
  size_t meta_at = cont != 0xFFFFFFFFu ? 0 : 4;
  int32_t meta_len;
  std::memcpy(&meta_len, buf + meta_at, 4);
  size_t fb_start = meta_at + 4;
  if (meta_len <= 0 || fb_start + static_cast<size_t>(meta_len) > len) return 2;
  Reader r{buf + fb_start, static_cast<size_t>(meta_len)};

  size_t root = r.indirect(0);
  if (!root) return 3;
  uint8_t header_type = 0;
  size_t f = r.field(root, 1);
  if (!f || !r.rd(f, &header_type) || header_type != kHeaderTensor) return 4;
  f = r.field(root, 2);
  if (!f) return 5;
  size_t tensor = r.indirect(f);
  int64_t body_length = 0;
  f = r.field(root, 3);
  if (f) r.rd(f, &body_length);

  uint8_t type_type = 0;
  f = r.field(tensor, 0);
  if (!f || !r.rd(f, &type_type)) return 6;
  f = r.field(tensor, 1);
  if (!f) return 6;
  size_t type_tbl = r.indirect(f);
  *type_type_out = type_type;
  *bit_width_out = 0;
  int dt = -1;
  if (type_type == kTypeFloatingPoint) {
    int16_t prec = kPrecisionHalf;
    f = r.field(type_tbl, 0);
    if (f) r.rd(f, &prec);
    dt = prec == kPrecisionHalf ? DT_F16 : prec == kPrecisionDouble ? DT_F64 : DT_F32;
  } else if (type_type == kTypeInt) {
    int32_t bits = 0;
    uint8_t is_signed = 0;
    f = r.field(type_tbl, 0);
    if (f) r.rd(f, &bits);
    f = r.field(type_tbl, 1);
    if (f) r.rd(f, &is_signed);
    *bit_width_out = bits;
    switch (bits) {
      case 8: dt = is_signed ? DT_I8 : DT_U8; break;
      case 16: dt = is_signed ? DT_I16 : DT_U16; break;
      case 32: dt = is_signed ? DT_I32 : DT_U32; break;
      case 64: dt = is_signed ? DT_I64 : DT_U64; break;
      default: return 100;
    }
  } else {
    return 100;
  }
  int64_t itemsize = dtype_itemsize(dt);

  f = r.field(tensor, 2);
  if (!f) return 8;
  size_t shape_vec = r.indirect(f);
  uint32_t n;
  if (!r.rd(shape_vec, &n)) return 8;
  if (n > static_cast<uint32_t>(kMaxRank)) return 101;
  int64_t nelem = 1;
  for (uint32_t i = 0; i < n; i++) {
    size_t dim_tbl = r.indirect(shape_vec + 4 + 4 * i);
    if (!dim_tbl) return 8;
    int64_t sz = 0;
    size_t sf = r.field(dim_tbl, 0);
    if (sf) r.rd(sf, &sz);
    if (sz < 0) return 8;
    shape[i] = sz;
    if (__builtin_mul_overflow(nelem, sz, &nelem)) return 8;
  }

  // Strides as stated; row-major when absent. The span is the last byte
  // any index reaches, plus one element.
  f = r.field(tensor, 3);
  if (f) {
    size_t sv = r.indirect(f);
    uint32_t sn;
    if (!r.rd(sv, &sn) || sn != n) return 9;
    for (uint32_t i = 0; i < n; i++) {
      if (!r.rd(sv + 4 + 8 * i, &strides[i])) return 9;
      if (strides[i] < 0) return 102;
    }
  } else {
    int64_t acc = itemsize;
    for (uint32_t i = n; i-- > 0;) {
      strides[i] = acc;
      if (__builtin_mul_overflow(acc, shape[i], &acc)) return 8;
    }
  }
  int64_t span = 0;
  if (nelem > 0) {
    int64_t last = 0;
    for (uint32_t i = 0; i < n; i++) {
      int64_t step;
      if (__builtin_mul_overflow(shape[i] - 1, strides[i], &step) ||
          __builtin_add_overflow(last, step, &last))
        return 9;
    }
    if (__builtin_add_overflow(last, itemsize, &span)) return 9;
  }

  f = r.field(tensor, 4);
  if (!f) return 10;
  int64_t buf_off, buf_len;
  if (!r.rd(f, &buf_off) || !r.rd(f + 8, &buf_len)) return 10;
  if (buf_off < 0 || buf_len < span) return 10;
  if (body_length > 0 &&
      (buf_off > body_length || buf_len > body_length - buf_off))
    return 10;
  size_t body_start = fb_start + static_cast<size_t>(meta_len);
  size_t off = body_start + static_cast<size_t>(buf_off);
  if (off > len || static_cast<size_t>(span) > len - off) return 11;

  *dtype = dt;
  *ndim = static_cast<int>(n);
  *data_off = off;
  *data_span = static_cast<size_t>(span);
  return 0;
}

}  // extern "C"
