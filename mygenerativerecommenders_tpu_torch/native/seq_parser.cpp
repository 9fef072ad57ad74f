// Fast sasrec_format.csv sequence parser (C ABI, loaded via ctypes).
//
// The host-side hot path of the data layer: the reference parses each
// row with Python eval() per __getitem__ (reco_dataset.py:101-127); the
// Python fallback here vectorizes but still costs ~1 min for ml-20m's
// 138k users. This parser streams the CSV once and writes the dense
// [U, L] arrays directly.
//
// CSV schema (written by data/preprocessor.py, byte-compatible with the
// reference): header row, then
//   user_id,"[id, id, ...]","[r, r, ...]","[ts, ts, ...]"[,extra...]
// Quoted fields contain Python list literals. Ratings may be floats
// (Amazon) — they are truncated to int like the reference's int64 cast.
//
// Split semantics mirror SequenceDataset.from_csv / the reference's
// RecoDataset.load_item: drop ignore_last_n tail, target = new last
// element, history = remainder (most recent L kept in chronological
// mode), right-padded with zeros.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
  const char* begin;
  const char* end;
};

// Split one CSV line into fields, honoring double quotes.
static void split_csv(const char* line, const char* line_end,
                      std::vector<Field>* out) {
  out->clear();
  const char* p = line;
  while (p <= line_end) {
    Field f;
    if (p < line_end && *p == '"') {
      ++p;
      f.begin = p;
      while (p < line_end && *p != '"') ++p;
      f.end = p;
      if (p < line_end) ++p;  // closing quote
      if (p < line_end && *p == ',') ++p;
    } else {
      f.begin = p;
      while (p < line_end && *p != ',') ++p;
      f.end = p;
      if (p < line_end) ++p;
    }
    out->push_back(f);
    if (f.end >= line_end && p >= line_end) break;
  }
}

// Parse "[a, b, c]" (ints or floats) into vals (truncated to int64).
static void parse_list(const Field& f, std::vector<int64_t>* vals) {
  vals->clear();
  const char* p = f.begin;
  const char* end = f.end;
  while (p < end && (*p == '[' || *p == ' ')) ++p;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == ',')) ++p;
    if (p >= end || *p == ']') break;
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) break;
    vals->push_back(static_cast<int64_t>(v));
    p = next;
  }
}

}  // namespace

extern "C" {

// Number of data rows (excluding header). -1 on open failure.
int64_t mgr_count_rows(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int64_t rows = 0;
  int c;
  int64_t newlines = 0;
  bool last_was_newline = true;
  while ((c = fgetc(fp)) != EOF) {
    if (c == '\n') {
      ++newlines;
      last_was_newline = true;
    } else {
      last_was_newline = false;
    }
  }
  rows = newlines - 1;  // header
  if (!last_was_newline) ++rows;  // no trailing newline
  fclose(fp);
  return rows < 0 ? 0 : rows;
}

// Parse into caller-allocated dense buffers of capacity [U, L].
// Returns the number of rows written, or -1 on failure.
int64_t mgr_parse_sequences(
    const char* path, int32_t L, int32_t ignore_last_n, int32_t chronological,
    int64_t U,
    int32_t* lengths,        // [U]
    int32_t* ids,            // [U, L]
    int32_t* ratings,        // [U, L]
    int32_t* timestamps,     // [U, L]
    int32_t* target_id,      // [U]
    int32_t* target_rating,  // [U]
    int32_t* target_ts,      // [U]
    int64_t* user_ids        // [U]
) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;

  std::string line;
  line.reserve(1 << 16);
  std::vector<Field> fields;
  std::vector<int64_t> s_ids, s_ratings, s_ts;
  int64_t row = 0;
  bool header = true;
  int idx_ids = 1, idx_ratings = 2, idx_ts = 3;

  char buf[1 << 16];
  std::string acc;
  while (fgets(buf, sizeof(buf), fp)) {
    acc += buf;
    if (acc.empty() || acc.back() != '\n') {
      if (!feof(fp)) continue;  // long line, keep accumulating
    }
    // strip trailing newline/cr
    while (!acc.empty() && (acc.back() == '\n' || acc.back() == '\r'))
      acc.pop_back();
    if (acc.empty()) { acc.clear(); continue; }

    split_csv(acc.data(), acc.data() + acc.size(), &fields);
    if (header) {
      // locate columns by name
      for (size_t i = 0; i < fields.size(); ++i) {
        std::string name(fields[i].begin, fields[i].end);
        if (name == "sequence_item_ids") idx_ids = static_cast<int>(i);
        else if (name == "sequence_ratings") idx_ratings = static_cast<int>(i);
        else if (name == "sequence_timestamps") idx_ts = static_cast<int>(i);
      }
      header = false;
      acc.clear();
      continue;
    }
    if (row >= U) break;
    if (static_cast<int>(fields.size()) <=
        (idx_ts > idx_ratings ? idx_ts : idx_ratings)) {
      acc.clear();
      continue;
    }

    user_ids[row] = strtoll(fields[0].begin, nullptr, 10);
    parse_list(fields[idx_ids], &s_ids);
    parse_list(fields[idx_ratings], &s_ratings);
    parse_list(fields[idx_ts], &s_ts);

    int64_t n = static_cast<int64_t>(s_ids.size()) - ignore_last_n;
    if (n < 1 || s_ratings.size() < s_ids.size() || s_ts.size() < s_ids.size()) {
      lengths[row] = 0;
      target_id[row] = target_rating[row] = target_ts[row] = 0;
      memset(ids + row * L, 0, sizeof(int32_t) * L);
      memset(ratings + row * L, 0, sizeof(int32_t) * L);
      memset(timestamps + row * L, 0, sizeof(int32_t) * L);
      ++row;
      acc.clear();
      continue;
    }

    target_id[row] = static_cast<int32_t>(s_ids[n - 1]);
    target_rating[row] = static_cast<int32_t>(s_ratings[n - 1]);
    target_ts[row] = static_cast<int32_t>(s_ts[n - 1]);

    int64_t hist = n - 1;
    int64_t keep = hist < L ? hist : L;
    // chronological: keep the most recent `keep`; reverse-chron: first after
    // reversal == most recent as well but ordered newest-first.
    int32_t* id_row = ids + row * L;
    int32_t* r_row = ratings + row * L;
    int32_t* t_row = timestamps + row * L;
    memset(id_row, 0, sizeof(int32_t) * L);
    memset(r_row, 0, sizeof(int32_t) * L);
    memset(t_row, 0, sizeof(int32_t) * L);
    if (chronological) {
      int64_t start = hist - keep;
      for (int64_t i = 0; i < keep; ++i) {
        id_row[i] = static_cast<int32_t>(s_ids[start + i]);
        r_row[i] = static_cast<int32_t>(s_ratings[start + i]);
        t_row[i] = static_cast<int32_t>(s_ts[start + i]);
      }
    } else {
      for (int64_t i = 0; i < keep; ++i) {  // newest first
        id_row[i] = static_cast<int32_t>(s_ids[hist - 1 - i]);
        r_row[i] = static_cast<int32_t>(s_ratings[hist - 1 - i]);
        t_row[i] = static_cast<int32_t>(s_ts[hist - 1 - i]);
      }
    }
    lengths[row] = static_cast<int32_t>(keep);
    ++row;
    acc.clear();
  }
  fclose(fp);
  return row;
}

}  // extern "C"
