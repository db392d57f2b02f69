// Native columnar codec — the varblock / PAX-encoding analog.
//
// The reference keeps its storage codecs native (AO varblock bit-packed
// headers in src/backend/cdb/cdbappendonlystorageformat.c; PAX's C++
// encoding stack in contrib/pax_storage). Here the hot byte-level work —
// delta+zigzag+LEB128 varint for int64 key/date columns, plus a fast CSV
// field splitter for parallel ingest (the gpfdist-class loader path) — is
// C++ behind a C ABI, loaded via ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC codec.cpp -o libcbcodec.so

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------- varint

// Encode int64 column as zigzag(delta) LEB128 varints.
// out must hold >= n * 10 bytes. Returns encoded byte count.
int64_t cb_dvarint_encode(const int64_t* src, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    uint64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        // unsigned arithmetic: wraparound is defined (no signed-overflow UB
        // for adjacent values near int64 extremes)
        uint64_t cur = static_cast<uint64_t>(src[i]);
        uint64_t du = cur - prev;
        prev = cur;
        int64_t d = static_cast<int64_t>(du);
        uint64_t z = (du << 1) ^ static_cast<uint64_t>(d >> 63);
        while (z >= 0x80) {
            *p++ = static_cast<uint8_t>(z) | 0x80;
            z >>= 7;
        }
        *p++ = static_cast<uint8_t>(z);
    }
    return p - out;
}

// Decode n values; returns bytes consumed, or -1 on truncated input.
int64_t cb_dvarint_decode(const uint8_t* src, int64_t nbytes, int64_t n,
                          int64_t* out) {
    const uint8_t* p = src;
    const uint8_t* end = src + nbytes;
    uint64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t z = 0;
        int shift = 0;
        while (true) {
            if (p >= end) return -1;
            uint8_t b = *p++;
            z |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
            if (shift > 63) return -1;
        }
        uint64_t du = (z >> 1) ^ (~(z & 1) + 1);  // un-zigzag, unsigned
        prev += du;
        out[i] = static_cast<int64_t>(prev);
    }
    return p - src;
}

// ------------------------------------------------------------- CSV ingest

// Split one CSV buffer into int64 values for a single column index.
// Simple dialect: no quoted delimiters (TPC-H .tbl style '|' files).
// Returns number of rows parsed, or -1 on a malformed number.
int64_t cb_parse_int64_column(const char* buf, int64_t nbytes, char delim,
                              int32_t col_index, int64_t* out,
                              int64_t max_rows) {
    int64_t rows = 0;
    const char* p = buf;
    const char* end = buf + nbytes;
    while (p < end && rows < max_rows) {
        // seek to column col_index of this line
        int32_t col = 0;
        while (col < col_index && p < end && *p != '\n') {
            if (*p == delim) col++;
            p++;
        }
        if (p >= end) break;
        if (col != col_index) { // short line
            while (p < end && *p != '\n') p++;
            p++;
            continue;
        }
        bool neg = false;
        if (p < end && *p == '-') { neg = true; p++; }
        int64_t v = 0;
        bool any = false;
        while (p < end && *p >= '0' && *p <= '9') {
            v = v * 10 + (*p - '0');
            any = true;
            p++;
        }
        if (!any) return -1;
        out[rows++] = neg ? -v : v;
        while (p < end && *p != '\n') p++;
        p++;
    }
    return rows;
}

// Parse a decimal(2)-style column into int64 hundredths (fixed point).
int64_t cb_parse_decimal_column(const char* buf, int64_t nbytes, char delim,
                                int32_t col_index, int32_t scale,
                                int64_t* out, int64_t max_rows) {
    int64_t pow10 = 1;
    for (int32_t i = 0; i < scale; i++) pow10 *= 10;
    int64_t rows = 0;
    const char* p = buf;
    const char* end = buf + nbytes;
    while (p < end && rows < max_rows) {
        int32_t col = 0;
        while (col < col_index && p < end && *p != '\n') {
            if (*p == delim) col++;
            p++;
        }
        if (p >= end) break;
        if (col != col_index) {
            while (p < end && *p != '\n') p++;
            p++;
            continue;
        }
        bool neg = false;
        if (p < end && *p == '-') { neg = true; p++; }
        int64_t whole = 0;
        bool any = false;
        while (p < end && *p >= '0' && *p <= '9') {
            whole = whole * 10 + (*p - '0');
            any = true;
            p++;
        }
        int64_t frac = 0;
        int64_t seen = 1;
        if (p < end && *p == '.') {
            p++;
            while (p < end && *p >= '0' && *p <= '9' && seen < pow10) {
                frac = frac * 10 + (*p - '0');
                seen *= 10;
                p++;
            }
            while (p < end && *p >= '0' && *p <= '9') p++; // extra digits
        }
        if (!any) return -1;
        int64_t v = whole * pow10 + frac * (pow10 / seen);
        out[rows++] = neg ? -v : v;
        while (p < end && *p != '\n') p++;
        p++;
    }
    return rows;
}

}  // extern "C"
