// Native columnar ingest: CSV and JSON-lines byte buffers -> typed
// column arrays.
//
// Counterpart of siddhi_tpu/native/csv_loader.cpp, a copy of its parser:
// a whole buffer parses in one C++ pass into the columnar layout the step
// consumes (int64/double/dictionary-id columns + null masks), with string
// attributes dictionary-encoded against a native hash map in order of
// first occurrence. Python sees each NEW unique string once: the port
// reads all of a parse's new strings back in one call
// (loader_dict_export) and encodes them into the app's StringDictionary
// in that order.
//
// Exposed as a C ABI for ctypes (no pybind11, no Python headers).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

int hex_val(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

void append_utf8(std::string& s, uint32_t cp) {
    if (cp < 0x80) {
        s.push_back((char)cp);
    } else if (cp < 0x800) {
        s.push_back((char)(0xC0 | (cp >> 6)));
        s.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        s.push_back((char)(0xE0 | (cp >> 12)));
        s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        s.push_back((char)(0xF0 | (cp >> 18)));
        s.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s.push_back((char)(0x80 | (cp & 0x3F)));
    }
}

struct Loader {
    std::unordered_map<std::string, int64_t> dict;
    std::vector<std::string> strings;   // id -> string

    int64_t encode(const char* s, size_t n) {
        std::string key(s, n);
        auto it = dict.find(key);
        if (it != dict.end()) return it->second;
        int64_t id = (int64_t)strings.size();
        dict.emplace(std::move(key), id);
        strings.emplace_back(s, n);
        return id;
    }
};

}  // namespace

extern "C" {

// column type codes (CsvLoader's _TYPE_CODES in native/__init__.py)
enum { COL_LONG = 0, COL_DOUBLE = 1, COL_STRING = 2, COL_BOOL = 3 };

Loader* loader_new() { return new Loader(); }
void loader_free(Loader* l) { delete l; }

int64_t loader_dict_size(Loader* l) { return (int64_t)l->strings.size(); }

// Strings [start, size) back to back into out (cap bytes), ends[k] the
// end offset of string start + k; returns how many were copied, or -1 if
// start is out of range or they do not fit (loader_dict_bytes says how
// many bytes they take).
int64_t loader_dict_bytes(Loader* l, int64_t start) {
    if (start < 0 || start > (int64_t)l->strings.size()) return -1;
    int64_t total = 0;
    for (size_t i = (size_t)start; i < l->strings.size(); ++i)
        total += (int64_t)l->strings[i].size();
    return total;
}

int64_t loader_dict_export(Loader* l, int64_t start, char* out, int64_t cap,
                           int64_t* ends) {
    int64_t total = loader_dict_bytes(l, start);
    if (total < 0 || total > cap) return -1;
    int64_t off = 0, k = 0;
    for (size_t i = (size_t)start; i < l->strings.size(); ++i, ++k) {
        const std::string& s = l->strings[i];
        std::memcpy(out + off, s.data(), s.size());
        off += (int64_t)s.size();
        ends[k] = off;
    }
    return k;
}

// Parse up to max_rows CSV lines from buf[0:len).
//   types[c]   : column type code
//   out_cols[c]: int64* (LONG), double* (DOUBLE), int64* dict ids (STRING),
//                uint8* (BOOL) — caller-allocated, max_rows each
//   out_masks[c]: uint8* null mask (1 = null), max_rows each
// Empty fields are null. Returns rows parsed (< 0 on error).
int64_t loader_parse_csv(Loader* l, const char* buf, int64_t len,
                         const int32_t* types, int32_t ncols,
                         void** out_cols, uint8_t** out_masks,
                         int64_t max_rows) {
    int64_t row = 0;
    int64_t i = 0;
    while (i < len && row < max_rows) {
        for (int32_t c = 0; c < ncols; ++c) {
            int64_t start = i;
            while (i < len && buf[i] != ',' && buf[i] != '\n' && buf[i] != '\r')
                ++i;
            int64_t n = i - start;
            bool is_null = (n == 0);
            out_masks[c][row] = is_null ? 1 : 0;
            switch (types[c]) {
                case COL_LONG: {
                    int64_t* col = (int64_t*)out_cols[c];
                    col[row] = is_null ? 0 : strtoll(buf + start, nullptr, 10);
                    break;
                }
                case COL_DOUBLE: {
                    double* col = (double*)out_cols[c];
                    col[row] = is_null ? 0.0 : strtod(buf + start, nullptr);
                    break;
                }
                case COL_STRING: {
                    int64_t* col = (int64_t*)out_cols[c];
                    col[row] = is_null ? 0 : l->encode(buf + start, (size_t)n);
                    break;
                }
                case COL_BOOL: {
                    uint8_t* col = (uint8_t*)out_cols[c];
                    col[row] = (!is_null && (buf[start] == 't' || buf[start] == 'T' ||
                                             buf[start] == '1'))
                                   ? 1
                                   : 0;
                    break;
                }
                default:
                    return -1;
            }
            if (i < len && buf[i] == ',') ++i;   // field separator
        }
        // consume the line terminator(s)
        while (i < len && (buf[i] == '\r' || buf[i] == '\n')) {
            if (buf[i] == '\n') { ++i; break; }
            ++i;
        }
        ++row;
    }
    return row;
}


// JSON-lines: one flat object per line. Fields resolve by name against
// the stream definition; missing keys / JSON null -> null mask; unknown
// keys are skipped. String values handle \" \\ \/ \n \t \r escapes and
// \uXXXX (incl. surrogate pairs), encoded to UTF-8.
//   names: concatenated field names; name_lens[c] their lengths
// Returns rows parsed (< 0 on error).
int64_t loader_parse_jsonl(Loader* l, const char* buf, int64_t len,
                           const char* names, const int32_t* name_lens,
                           const int32_t* types, int32_t ncols,
                           void** out_cols, uint8_t** out_masks,
                           int64_t max_rows) {
    std::vector<std::pair<const char*, int32_t>> fields(ncols);
    {
        const char* p = names;
        for (int32_t c = 0; c < ncols; ++c) {
            fields[c] = {p, name_lens[c]};
            p += name_lens[c];
        }
    }
    std::string sval;
    int64_t row = 0, i = 0;
    while (i < len && row < max_rows) {
        // skip blank space before the object
        while (i < len && (buf[i] == ' ' || buf[i] == '\t' ||
                           buf[i] == '\r' || buf[i] == '\n'))
            ++i;
        if (i >= len) break;
        if (buf[i] != '{') return -1;
        ++i;
        for (int32_t c = 0; c < ncols; ++c) out_masks[c][row] = 1;
        bool done = false;
        while (!done) {
            while (i < len && (buf[i] == ' ' || buf[i] == '\t')) ++i;
            if (i < len && buf[i] == '}') { ++i; done = true; break; }
            if (i >= len || buf[i] != '"') return -1;
            ++i;
            int64_t kstart = i;
            while (i < len && buf[i] != '"') {
                if (buf[i] == '\\') ++i;
                ++i;
            }
            int64_t klen = i - kstart;
            if (i >= len) return -1;
            ++i;  // closing quote
            while (i < len && (buf[i] == ' ' || buf[i] == '\t')) ++i;
            if (i >= len || buf[i] != ':') return -1;
            ++i;
            while (i < len && (buf[i] == ' ' || buf[i] == '\t')) ++i;
            int32_t col = -1;
            for (int32_t c = 0; c < ncols; ++c)
                if (fields[c].second == klen &&
                    memcmp(fields[c].first, buf + kstart, (size_t)klen) == 0) {
                    col = c;
                    break;
                }
            bool is_null = false;
            sval.clear();
            bool have_str = false;
            int64_t vstart = i, vlen = 0;
            if (i < len && buf[i] == '"') {
                ++i;
                have_str = true;
                while (i < len && buf[i] != '"') {
                    char ch = buf[i];
                    if (ch == '\\' && i + 1 < len) {
                        ++i;
                        char e = buf[i];
                        if (e == 'u' && i + 4 < len) {
                            int h0 = hex_val(buf[i + 1]), h1 = hex_val(buf[i + 2]);
                            int h2 = hex_val(buf[i + 3]), h3 = hex_val(buf[i + 4]);
                            if (h0 < 0 || h1 < 0 || h2 < 0 || h3 < 0) return -1;
                            uint32_t cp = (uint32_t)((h0 << 12) | (h1 << 8) |
                                                     (h2 << 4) | h3);
                            i += 4;
                            if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 < len &&
                                buf[i + 1] == '\\' && buf[i + 2] == 'u') {
                                int g0 = hex_val(buf[i + 3]), g1 = hex_val(buf[i + 4]);
                                int g2 = hex_val(buf[i + 5]), g3 = hex_val(buf[i + 6]);
                                if (g0 < 0 || g1 < 0 || g2 < 0 || g3 < 0) return -1;
                                uint32_t lo = (uint32_t)((g0 << 12) | (g1 << 8) |
                                                         (g2 << 4) | g3);
                                if (lo >= 0xDC00 && lo <= 0xDFFF) {
                                    cp = 0x10000 + ((cp - 0xD800) << 10) +
                                         (lo - 0xDC00);
                                    i += 6;
                                }
                            }
                            append_utf8(sval, cp);
                            ++i;
                            continue;
                        }
                        switch (e) {
                            case 'n': ch = '\n'; break;
                            case 't': ch = '\t'; break;
                            case 'r': ch = '\r'; break;
                            case 'b': ch = '\b'; break;
                            case 'f': ch = '\f'; break;
                            default: ch = e; break;   // " \\ /
                        }
                    }
                    sval.push_back(ch);
                    ++i;
                }
                if (i >= len) return -1;
                ++i;  // closing quote
            } else if (i < len && buf[i] == 'n') {
                is_null = true;
                while (i < len && buf[i] != ',' && buf[i] != '}' &&
                       buf[i] != '\n')
                    ++i;
                if (i >= len || buf[i] == '\n') return -1;  // missing '}'
            } else {
                vstart = i;
                while (i < len && buf[i] != ',' && buf[i] != '}' &&
                       buf[i] != '\n')
                    ++i;
                vlen = i - vstart;
                if (vlen == 0) is_null = true;
            }
            if (col >= 0) {
                out_masks[col][row] = is_null ? 1 : 0;
                const char* vp = have_str ? sval.data() : buf + vstart;
                size_t vn = have_str ? sval.size() : (size_t)vlen;
                switch (types[col]) {
                    case COL_LONG: {
                        int64_t* out = (int64_t*)out_cols[col];
                        out[row] = is_null ? 0 : strtoll(vp, nullptr, 10);
                        break;
                    }
                    case COL_DOUBLE: {
                        double* out = (double*)out_cols[col];
                        out[row] = is_null ? 0.0 : strtod(vp, nullptr);
                        break;
                    }
                    case COL_STRING: {
                        int64_t* out = (int64_t*)out_cols[col];
                        out[row] = is_null ? 0 : l->encode(vp, vn);
                        break;
                    }
                    case COL_BOOL: {
                        uint8_t* out = (uint8_t*)out_cols[col];
                        out[row] = (!is_null && vn > 0 &&
                                    (vp[0] == 't' || vp[0] == 'T' ||
                                     vp[0] == '1'))
                                       ? 1
                                       : 0;
                        break;
                    }
                    default:
                        return -1;
                }
            }
            while (i < len && (buf[i] == ' ' || buf[i] == '\t')) ++i;
            if (i < len && buf[i] == ',') { ++i; continue; }
            if (i < len && buf[i] == '}') { ++i; done = true; }
        }
        while (i < len && buf[i] != '\n') ++i;
        if (i < len) ++i;
        ++row;
    }
    return row;
}

}  // extern "C"
