// Native string-dictionary encoder: the hot half of columnar string
// ingest (a copy of siddhi_tpu/native/strdict.cpp). The reference engine
// pays a per-event string cost at every group-by (GroupByKeyGenerator.java:37
// string keys); this engine dictionary-encodes whole string columns at the
// ingest edge instead, and this file makes that edge native: one C++ pass
// over a numpy object array, one open-addressing hash probe per string, no
// Python per-row work. Python stays authoritative for the id space: NEW
// strings come back as misses, Python allocates their ids
// (StringDictionary.encode) and inserts them here, so snapshots and
// restores only ever deal with the Python-side list.
//
// Compiled against the CPython C API (PyUnicode readers); loaded with
// ctypes.PyDLL so calls run under the GIL, which the PyObject* accesses
// require (see native/__init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; ++i) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ull;
    }
    return h;
}

struct Entry {
    uint64_t hash;
    int64_t id;       // -1 == empty
    uint64_t off;     // into arena
    uint32_t len;
};

// Open-addressing (linear probe) string -> id map with an append-only
// byte arena. ~3x faster probes than std::unordered_map<std::string,..>
// at 65k-row batches of short keys (no per-node allocation, no bucket
// pointer chase).
struct StrDict {
    std::vector<Entry> table;
    std::string arena;
    size_t count = 0;

    StrDict() : table(1 << 12) { clear(); }

    void clear() {
        for (auto& e : table) e.id = -1;
        arena.clear();
        count = 0;
    }

    void grow() {
        std::vector<Entry> old;
        old.swap(table);
        table.resize(old.size() * 2);
        for (auto& e : table) e.id = -1;
        size_t mask = table.size() - 1;
        for (const auto& e : old) {
            if (e.id < 0) continue;
            size_t i = e.hash & mask;
            while (table[i].id >= 0) i = (i + 1) & mask;
            table[i] = e;
        }
    }

    // -1 == absent
    inline int64_t find(const char* s, size_t n, uint64_t h) const {
        size_t mask = table.size() - 1;
        size_t i = h & mask;
        while (true) {
            const Entry& e = table[i];
            if (e.id < 0) return -1;
            if (e.hash == h && e.len == n &&
                std::memcmp(arena.data() + e.off, s, n) == 0)
                return e.id;
            i = (i + 1) & mask;
        }
    }

    void insert(const char* s, size_t n, int64_t id) {
        uint64_t h = fnv1a(s, n);
        if (find(s, n, h) >= 0) return;
        if ((count + 1) * 4 >= table.size() * 3) grow();  // load < 0.75
        size_t mask = table.size() - 1;
        size_t i = h & mask;
        while (table[i].id >= 0) i = (i + 1) & mask;
        table[i] = Entry{h, id, (uint64_t)arena.size(), (uint32_t)n};
        arena.append(s, n);
        ++count;
    }
};

}  // namespace

extern "C" {

StrDict* strdict_new() { return new StrDict(); }
void strdict_free(StrDict* d) { delete d; }
void strdict_clear(StrDict* d) { d->clear(); }
int64_t strdict_count(StrDict* d) { return (int64_t)d->count; }

void strdict_insert(StrDict* d, const char* s, int64_t n, int64_t id) {
    d->insert(s, (size_t)n, id);
}

// Encode a numpy object array (items = its PyObject** data) into out.
// None -> null_id; known strings -> their id; NEW strings and non-str
// values -> miss_marker (Python resolves those, then strdict_insert's
// them). Returns the number of misses. Requires the GIL (load with
// ctypes.PyDLL).
int64_t strdict_encode(StrDict* d, PyObject** items, int64_t n,
                       int64_t* out, int64_t null_id, int64_t miss_marker) {
    int64_t misses = 0;
    // tiny inline cache: consecutive rows often repeat the same object
    // (np.take of a small symbol universe shares PyObject pointers)
    PyObject* last_obj = nullptr;
    int64_t last_id = 0;
    for (int64_t i = 0; i < n; ++i) {
        PyObject* o = items[i];
        if (o == last_obj) {
            out[i] = last_id;
            continue;
        }
        if (o == Py_None) {
            out[i] = null_id;
            last_obj = o;
            last_id = null_id;
            continue;
        }
        if (!PyUnicode_Check(o)) {
            out[i] = miss_marker;
            ++misses;
            last_obj = nullptr;
            continue;
        }
        Py_ssize_t len;
        const char* s = PyUnicode_AsUTF8AndSize(o, &len);
        if (s == nullptr) {
            PyErr_Clear();
            out[i] = miss_marker;
            ++misses;
            last_obj = nullptr;
            continue;
        }
        int64_t id = d->find(s, (size_t)len, fnv1a(s, (size_t)len));
        if (id < 0) {
            out[i] = miss_marker;
            ++misses;
            last_obj = nullptr;
        } else {
            out[i] = id;
            last_obj = o;
            last_id = id;
        }
    }
    return misses;
}

}  // extern "C"
