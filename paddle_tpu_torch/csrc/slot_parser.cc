// MultiSlot text-format parser.
//
// Native fast path for the dataset pipeline — the counterpart of the
// reference's MultiSlotDataFeed::ParseOneInstance (data_feed.cc:893) and
// the SlotRecord packing path, rebuilt batched: parse a whole text block
// into columnar slot buffers in one call instead of per-instance
// virtual-dispatched parsing.
//
// Line format (SURVEY Appendix A.5): per configured slot,
//   <num> <feasign>*num
// tokens; uint64 or float by slot type; unused slots skipped positionally.
//
// Output layout per slot: CSR-style — values plus a lengths array (one
// length per line), so Python can build padded/bucketed device batches
// without re-walking the text.
//
// Robustness: each line is copied into a NUL-terminated scratch buffer so
// strtoX can never walk past the line (a short line fails cleanly instead
// of stealing tokens from the next line or reading past the block), and a
// failed line restores ALL slot buffers to their pre-line sizes.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct SlotBuf {
  std::vector<uint64_t> u64;
  std::vector<float> f32;
  std::vector<int32_t> lengths;  // one per parsed line
};

struct Parser {
  int num_slots = 0;
  std::vector<uint8_t> is_float;  // per slot
  std::vector<uint8_t> used;      // per slot: emit or skip
  std::vector<SlotBuf> bufs;      // per slot (indexed by slot id)
  std::vector<char> line_buf;     // NUL-terminated scratch for one line
  int64_t lines = 0;
  int64_t errors = 0;
};

}  // namespace

extern "C" {

void* slotp_create(int num_slots, const uint8_t* is_float, const uint8_t* used) {
  Parser* ps = new Parser();
  ps->num_slots = num_slots;
  ps->is_float.assign(is_float, is_float + num_slots);
  ps->used.assign(used, used + num_slots);
  ps->bufs.resize(num_slots);
  return ps;
}

void slotp_destroy(void* p) { delete static_cast<Parser*>(p); }

// Parse a text block (may contain many lines). Returns #lines parsed OK.
int64_t slotp_parse(void* p, const char* data, int64_t len) {
  Parser* ps = static_cast<Parser*>(p);
  const char* cur = data;
  const char* end = data + len;
  int64_t ok = 0;
  std::vector<size_t> snap_u64(ps->num_slots), snap_f32(ps->num_slots),
      snap_len(ps->num_slots);
  while (cur < end) {
    const char* line_end =
        static_cast<const char*>(memchr(cur, '\n', end - cur));
    if (!line_end) line_end = end;
    size_t line_len = static_cast<size_t>(line_end - cur);

    // skip blank lines
    bool blank = true;
    for (size_t i = 0; i < line_len; ++i)
      if (!isspace(static_cast<unsigned char>(cur[i]))) { blank = false; break; }
    if (blank) {
      cur = (line_end < end) ? line_end + 1 : end;
      continue;
    }

    // NUL-terminated copy bounds every strtoX to this line
    ps->line_buf.assign(cur, cur + line_len);
    ps->line_buf.push_back('\0');
    char* q = ps->line_buf.data();

    // snapshot buffer sizes for full rollback on a bad line
    for (int s = 0; s < ps->num_slots; ++s) {
      snap_u64[s] = ps->bufs[s].u64.size();
      snap_f32[s] = ps->bufs[s].f32.size();
      snap_len[s] = ps->bufs[s].lengths.size();
    }

    bool good = true;
    for (int s = 0; s < ps->num_slots && good; ++s) {
      char* next = nullptr;
      long n = strtol(q, &next, 10);
      if (next == q || n < 0) { good = false; break; }
      q = next;
      SlotBuf& buf = ps->bufs[s];
      if (ps->used[s]) {
        if (ps->is_float[s]) {
          for (long i = 0; i < n && good; ++i) {
            float v = strtof(q, &next);
            if (next == q) { good = false; break; }
            buf.f32.push_back(v);
            q = next;
          }
        } else {
          for (long i = 0; i < n && good; ++i) {
            uint64_t v = strtoull(q, &next, 10);
            if (next == q) { good = false; break; }
            buf.u64.push_back(v);
            q = next;
          }
        }
        if (good) buf.lengths.push_back(static_cast<int32_t>(n));
      } else {
        for (long i = 0; i < n && good; ++i) {
          strtod(q, &next);
          if (next == q) good = false;
          q = next;
        }
      }
    }
    if (good) {
      ++ok;
    } else {
      ++ps->errors;
      for (int s = 0; s < ps->num_slots; ++s) {
        ps->bufs[s].u64.resize(snap_u64[s]);
        ps->bufs[s].f32.resize(snap_f32[s]);
        ps->bufs[s].lengths.resize(snap_len[s]);
      }
    }
    cur = (line_end < end) ? line_end + 1 : end;
  }
  ps->lines += ok;
  return ok;
}

int64_t slotp_lines(void* p) { return static_cast<Parser*>(p)->lines; }
int64_t slotp_errors(void* p) { return static_cast<Parser*>(p)->errors; }

int64_t slotp_slot_value_count(void* p, int slot) {
  Parser* ps = static_cast<Parser*>(p);
  const SlotBuf& b = ps->bufs[slot];
  return ps->is_float[slot] ? b.f32.size() : b.u64.size();
}

// Copy out values + lengths for a slot and leave internal buffers intact.
void slotp_slot_fetch(void* p, int slot, void* values, int32_t* lengths) {
  Parser* ps = static_cast<Parser*>(p);
  SlotBuf& b = ps->bufs[slot];
  if (ps->is_float[slot]) {
    memcpy(values, b.f32.data(), b.f32.size() * sizeof(float));
  } else {
    memcpy(values, b.u64.data(), b.u64.size() * sizeof(uint64_t));
  }
  memcpy(lengths, b.lengths.data(), b.lengths.size() * sizeof(int32_t));
}

// Reset parsed buffers (keep schema) for the next batch of lines.
void slotp_reset(void* p) {
  Parser* ps = static_cast<Parser*>(p);
  for (auto& b : ps->bufs) {
    b.u64.clear();
    b.f32.clear();
    b.lengths.clear();
  }
  ps->lines = 0;
  ps->errors = 0;
}

}  // extern "C"
