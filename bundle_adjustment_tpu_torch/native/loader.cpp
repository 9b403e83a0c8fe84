// Native columnar flat-file loader.
//
// The reference's I/O layer (survey H1-H13) is line-by-line Java with one
// object allocated per token (LockFileReader.java:69-103 and the flat/AICON
// readers under util/io/reader/).  At the metrology scale of the bundled
// example (~10k image points) that is fine; at this framework's target scale
// (100k..1M points, BASELINE.json configs 4-5) a Python/Java line loop is
// minutes of wall-clock before the first device byte moves.
//
// This file is the framework's data-loader hot path: an mmap'd, single-pass,
// allocation-light whitespace-table parser with string-key interning.  It is
// deliberately format-agnostic — per-format semantics (active flags, datum
// flags, optional columns) stay in Python, vectorised over the returned
// arrays — so one ~300-line kernel serves every flat format (H3-H7) and
// every AICON columnar format (H9-H13).
//
// Column spec characters:
//   'f'  double column (strtod; token must parse fully or the row is
//        dropped, matching the reference's catch-NumberFormatException-and-
//        skip-line contract, e.g. ObjectCoordinateFlatFileReader.java:79-94)
//   'i'  integer column (strtoll full-consume; dropped row on failure,
//        matching Integer.parseInt semantics)
//   's'  string column, interned to a dense id (flags compared as strings
//        in the reference keep exact semantics, e.g. the "datum" column
//        test `cols[4] == "1"`)
//   'x'  column present but ignored
// Columns beyond a row's token count are NaN (numeric) / -1 (string); the
// per-row token count is returned so optional-column logic can be applied
// exactly.  Lines starting with the comment character (after leading
// whitespace) are skipped; a UTF-8 BOM is stripped (LockFileReader.java:84).
//
// Exposed as a plain C API consumed via ctypes (no pybind11 in this image).

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Table {
  int64_t rows = 0;
  int nf = 0;  // numeric columns in spec ('f' or 'i')
  int nk = 0;  // string-key columns in spec
  std::vector<double> floats;   // rows * nf, row-major
  std::vector<int32_t> keys;    // rows * nk, row-major, -1 = missing
  std::vector<int32_t> ncols;   // tokens seen per row
  // per key column: interning table + insertion-ordered unique strings
  std::vector<std::vector<std::string>> uniq;
  std::string error;
};

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool mapped = false;
  std::vector<char> fallback;

  bool open_file(const char* path, std::string* err) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      *err = std::string("open failed: ") + std::strerror(errno);
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      *err = std::string("fstat failed: ") + std::strerror(errno);
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = "";
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p != MAP_FAILED) {
      data = static_cast<const char*>(p);
      mapped = true;
      return true;
    }
    // mmap can fail on special filesystems: fall back to read()
    fallback.resize(size);
    size_t got = 0;
    while (got < size) {
      ssize_t r = ::read(fd, fallback.data() + got, size - got);
      if (r <= 0) {
        *err = std::string("read failed: ") + std::strerror(errno);
        return false;
      }
      got += static_cast<size_t>(r);
    }
    data = fallback.data();
    return true;
  }

  ~MappedFile() {
    if (mapped) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\v' || c == '\f'; }

}  // namespace

extern "C" {

// Parse `path` according to `colspec`.  Returns an opaque handle (nullptr on
// error; *err then points at a static buffer with the message).
void* ba_parse_table(const char* path, const char* colspec, char comment,
                     const char** err) {
  static thread_local std::string err_buf;
  auto* t = new Table();
  const int ncols_spec = static_cast<int>(std::strlen(colspec));
  std::vector<int> float_slot(ncols_spec, -1), key_slot(ncols_spec, -1);
  std::vector<char> kind(ncols_spec);
  for (int c = 0; c < ncols_spec; ++c) {
    kind[c] = colspec[c];
    if (colspec[c] == 'f' || colspec[c] == 'i') float_slot[c] = t->nf++;
    else if (colspec[c] == 's') key_slot[c] = t->nk++;
    else if (colspec[c] == 'x') {}
    else {
      err_buf = "bad colspec char";
      *err = err_buf.c_str();
      delete t;
      return nullptr;
    }
  }
  t->uniq.resize(t->nk);
  std::vector<std::unordered_map<std::string, int32_t>> intern(t->nk);

  MappedFile f;
  if (!f.open_file(path, &err_buf)) {
    *err = err_buf.c_str();
    delete t;
    return nullptr;
  }

  const char* p = f.data;
  const char* end = f.data + f.size;
  // UTF-8 BOM (LockFileReader.java:84 strips ﻿)
  if (f.size >= 3 && static_cast<unsigned char>(p[0]) == 0xEF &&
      static_cast<unsigned char>(p[1]) == 0xBB &&
      static_cast<unsigned char>(p[2]) == 0xBF)
    p += 3;

  std::vector<double> row_f(t->nf);
  std::vector<int32_t> row_k(t->nk);
  std::string tokbuf;  // strtod needs NUL termination; reused buffer

  while (p < end) {
    const char* line = p;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    p = nl ? nl + 1 : end;
    if (line_end > line && line_end[-1] == '\r') --line_end;

    // skip leading whitespace; blank / comment lines
    while (line < line_end && is_space(*line)) ++line;
    if (line == line_end) continue;
    if (comment && *line == comment) continue;

    for (int i = 0; i < t->nf; ++i) row_f[i] = NAN;
    for (int i = 0; i < t->nk; ++i) row_k[i] = -1;

    int col = 0;
    bool bad = false;
    const char* q = line;
    while (q < line_end) {
      const char* tok = q;
      while (q < line_end && !is_space(*q)) ++q;
      const size_t len = static_cast<size_t>(q - tok);
      while (q < line_end && is_space(*q)) ++q;
      if (col < ncols_spec) {
        if (kind[col] == 'f') {
          tokbuf.assign(tok, len);
          char* conv_end = nullptr;
          const double v = strtod(tokbuf.c_str(), &conv_end);
          if (conv_end != tokbuf.c_str() + len) { bad = true; break; }
          row_f[float_slot[col]] = v;
        } else if (kind[col] == 'i') {
          tokbuf.assign(tok, len);
          char* conv_end = nullptr;
          const long long v = strtoll(tokbuf.c_str(), &conv_end, 10);
          if (conv_end != tokbuf.c_str() + len) { bad = true; break; }
          row_f[float_slot[col]] = static_cast<double>(v);
        } else if (kind[col] == 'x') {
          // ignored column
        } else {  // 's'
          const int k = key_slot[col];
          tokbuf.assign(tok, len);
          auto it = intern[k].find(tokbuf);
          int32_t id;
          if (it == intern[k].end()) {
            id = static_cast<int32_t>(t->uniq[k].size());
            intern[k].emplace(tokbuf, id);
            t->uniq[k].push_back(tokbuf);
          } else {
            id = it->second;
          }
          row_k[k] = id;
        }
      }
      ++col;
    }
    if (bad) continue;  // reference readers skip unparsable lines

    t->floats.insert(t->floats.end(), row_f.begin(), row_f.end());
    t->keys.insert(t->keys.end(), row_k.begin(), row_k.end());
    t->ncols.push_back(col);
    ++t->rows;
  }
  return t;
}

int64_t ba_rows(void* h) { return static_cast<Table*>(h)->rows; }
int ba_nfloat(void* h) { return static_cast<Table*>(h)->nf; }
int ba_nkeys(void* h) { return static_cast<Table*>(h)->nk; }

void ba_copy_floats(void* h, double* out) {
  auto* t = static_cast<Table*>(h);
  std::memcpy(out, t->floats.data(), t->floats.size() * sizeof(double));
}

void ba_copy_keys(void* h, int32_t* out) {
  auto* t = static_cast<Table*>(h);
  std::memcpy(out, t->keys.data(), t->keys.size() * sizeof(int32_t));
}

void ba_copy_ncols(void* h, int32_t* out) {
  auto* t = static_cast<Table*>(h);
  std::memcpy(out, t->ncols.data(), t->ncols.size() * sizeof(int32_t));
}

int64_t ba_num_unique(void* h, int kcol) {
  return static_cast<int64_t>(static_cast<Table*>(h)->uniq[kcol].size());
}

int64_t ba_unique_blob_size(void* h, int kcol) {
  int64_t n = 0;
  for (const auto& s : static_cast<Table*>(h)->uniq[kcol]) n += s.size();
  return n;
}

// offsets has num_unique+1 entries; blob is the concatenated UTF-8 bytes.
void ba_copy_unique(void* h, int kcol, char* blob, int64_t* offsets) {
  auto* t = static_cast<Table*>(h);
  int64_t off = 0;
  int64_t i = 0;
  for (const auto& s : t->uniq[kcol]) {
    offsets[i++] = off;
    std::memcpy(blob + off, s.data(), s.size());
    off += static_cast<int64_t>(s.size());
  }
  offsets[i] = off;
}

void ba_free(void* h) { delete static_cast<Table*>(h); }

}  // extern "C"
