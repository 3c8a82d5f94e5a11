// Native columnar CSV loader.
//
// The reference's storage<->compute data plane is the JVM mongo-spark
// connector (reference: model_builder.py:74-76, projection.py:58-61);
// this framework's equivalent is a host-side columnar loader feeding
// jax.device_put (SURVEY.md section 2). This C++ core does the
// byte-level work — one pass over the file building a cell index with
// RFC-4180 quote handling, plus vectorized numeric column extraction —
// so Python never iterates rows character by character.
//
// C ABI (ctypes-consumed, see native/loader.py):
//   csv_open(path)            -> handle (0 on failure)
//   csv_num_rows/cols(h)      -> dimensions (rows exclude the header)
//   csv_cell(h, row, col, &n) -> unquoted cell bytes (row -1 = header)
//   csv_col_is_numeric(h, c)  -> 1 iff every cell parses as double/empty
//   csv_fill_numeric(h, c, out) -> doubles, NaN for empty cells
//   csv_close(h)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

struct Cell {
  uint64_t offset;
  uint32_t length;
  bool quoted;
};

struct CsvFile {
  std::string data;        // whole file
  std::string unquoted;    // scratch storage for dequoted cells
  std::vector<Cell> cells; // row-major, including header row
  size_t num_cols = 0;
  size_t num_rows = 0;     // excluding header
};

// Parse the raw bytes into the cell index. Handles quoted fields with
// embedded commas/newlines and doubled quotes.
bool parse(CsvFile* f) {
  const std::string& s = f->data;
  size_t i = 0, n = s.size();
  std::vector<Cell> row;
  bool first_row = true;
  while (i <= n) {
    // parse one cell starting at i
    Cell cell{i, 0, false};
    if (i < n && s[i] == '"') {
      cell.quoted = true;
      cell.offset = i + 1;
      size_t j = i + 1;
      while (j < n) {
        if (s[j] == '"') {
          if (j + 1 < n && s[j + 1] == '"') { j += 2; continue; }
          break;
        }
        ++j;
      }
      cell.length = static_cast<uint32_t>(j - cell.offset);
      i = (j < n) ? j + 1 : j;  // past closing quote
    } else {
      size_t j = i;
      while (j < n && s[j] != ',' && s[j] != '\n' && s[j] != '\r') ++j;
      cell.length = static_cast<uint32_t>(j - cell.offset);
      i = j;
    }
    row.push_back(cell);
    if (i >= n) {
      bool empty_tail =
          row.size() == 1 && row[0].length == 0 && !row[0].quoted;
      if (!empty_tail) {
        if (first_row) { f->num_cols = row.size(); first_row = false; }
        else ++f->num_rows;
        f->cells.insert(f->cells.end(), row.begin(), row.end());
        // pad short rows so the index stays rectangular
        for (size_t k = row.size(); k < f->num_cols; ++k)
          f->cells.push_back(Cell{0, 0, false});
      }
      break;
    }
    if (s[i] == ',') { ++i; continue; }
    // row terminator (\n, \r\n or \r)
    if (s[i] == '\r') { ++i; if (i < n && s[i] == '\n') ++i; }
    else if (s[i] == '\n') ++i;
    bool blank_line = row.size() == 1 && row[0].length == 0 && !row[0].quoted;
    if (!blank_line) {
      if (first_row) { f->num_cols = row.size(); first_row = false; }
      else ++f->num_rows;
      f->cells.insert(f->cells.end(), row.begin(), row.end());
      for (size_t k = row.size(); k < f->num_cols; ++k)
        f->cells.push_back(Cell{0, 0, false});
      if (f->num_cols && row.size() > f->num_cols) return false; // ragged wide
    }
    row.clear();
  }
  return f->num_cols > 0;
}

const Cell* cell_at(const CsvFile* f, long long row, size_t col) {
  // row -1 addresses the header
  size_t index = static_cast<size_t>(row + 1) * f->num_cols + col;
  if (col >= f->num_cols || index >= f->cells.size()) return nullptr;
  return &f->cells[index];
}

}  // namespace

extern "C" {

void* csv_open(const char* path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  auto* f = new CsvFile();
  in.seekg(0, std::ios::end);
  f->data.resize(static_cast<size_t>(in.tellg()));
  in.seekg(0);
  in.read(&f->data[0], static_cast<std::streamsize>(f->data.size()));
  if (!parse(f)) { delete f; return nullptr; }
  return f;
}

void csv_close(void* handle) { delete static_cast<CsvFile*>(handle); }

uint64_t csv_num_rows(void* handle) {
  return static_cast<CsvFile*>(handle)->num_rows;
}

uint64_t csv_num_cols(void* handle) {
  return static_cast<CsvFile*>(handle)->num_cols;
}

// Returns a pointer to the cell's bytes and writes its length. Quoted
// cells containing doubled quotes are unescaped into scratch storage.
const char* csv_cell(void* handle, long long row, uint64_t col,
                     uint32_t* length) {
  auto* f = static_cast<CsvFile*>(handle);
  const Cell* c = cell_at(f, row, col);
  if (!c) { *length = 0; return nullptr; }
  const char* p = f->data.data() + c->offset;
  if (c->quoted && memchr(p, '"', c->length)) {
    f->unquoted.clear();
    for (uint32_t i = 0; i < c->length; ++i) {
      f->unquoted.push_back(p[i]);
      if (p[i] == '"' && i + 1 < c->length && p[i + 1] == '"') ++i;
    }
    *length = static_cast<uint32_t>(f->unquoted.size());
    return f->unquoted.data();
  }
  *length = c->length;
  return p;
}

// Matches Python float() semantics (the fallback path's parser): no hex
// literals, cells longer than 511 bytes are treated as strings by both
// paths (loader.py applies the same cap to the fallback).
int csv_col_is_numeric(void* handle, uint64_t col) {
  auto* f = static_cast<CsvFile*>(handle);
  for (size_t r = 0; r < f->num_rows; ++r) {
    const Cell* c = cell_at(f, static_cast<long long>(r), col);
    if (!c || c->length == 0) continue;  // empty = missing, allowed
    char buf[512];
    if (c->length >= sizeof(buf)) return 0;
    memcpy(buf, f->data.data() + c->offset, c->length);
    buf[c->length] = '\0';
    if (memchr(buf, 'x', c->length) || memchr(buf, 'X', c->length)) return 0;
    char* end = nullptr;
    strtod(buf, &end);
    while (end && *end && isspace(static_cast<unsigned char>(*end))) ++end;
    if (!end || *end != '\0' || end == buf) return 0;
  }
  return 1;
}

// Total bytes needed by csv_fill_strings for this column (cells +
// one NUL separator per cell).
uint64_t csv_col_string_bytes(void* handle, uint64_t col) {
  auto* f = static_cast<CsvFile*>(handle);
  uint64_t total = 0;
  for (size_t r = 0; r < f->num_rows; ++r) {
    const Cell* c = cell_at(f, static_cast<long long>(r), col);
    if (c) total += c->length;
    total += 1;  // separator
  }
  return total;
}

// Writes every cell of the column into `out`, NUL-separated, unescaping
// doubled quotes. One bulk call instead of num_rows ctypes round trips.
void csv_fill_strings(void* handle, uint64_t col, char* out) {
  auto* f = static_cast<CsvFile*>(handle);
  for (size_t r = 0; r < f->num_rows; ++r) {
    const Cell* c = cell_at(f, static_cast<long long>(r), col);
    if (c && c->length) {
      const char* p = f->data.data() + c->offset;
      if (c->quoted && memchr(p, '"', c->length)) {
        for (uint32_t i = 0; i < c->length; ++i) {
          *out++ = p[i];
          if (p[i] == '"' && i + 1 < c->length && p[i + 1] == '"') ++i;
        }
      } else {
        memcpy(out, p, c->length);
        out += c->length;
      }
    }
    *out++ = '\0';
  }
}

void csv_fill_numeric(void* handle, uint64_t col, double* out) {
  auto* f = static_cast<CsvFile*>(handle);
  for (size_t r = 0; r < f->num_rows; ++r) {
    const Cell* c = cell_at(f, static_cast<long long>(r), col);
    if (!c || c->length == 0) { out[r] = NAN; continue; }
    char buf[512];
    if (c->length >= sizeof(buf)) { out[r] = NAN; continue; }
    memcpy(buf, f->data.data() + c->offset, c->length);
    buf[c->length] = '\0';
    out[r] = strtod(buf, nullptr);
  }
}

}  // extern "C"
