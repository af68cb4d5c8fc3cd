// A copy of midi_emotion_tpu/native/tokenizer.cc, unchanged but for this
// line and the next: the torch port keeps its own copies.
// Native tokenizer core.
//
// C++ implementation of the delta-time tokenization inner loop
// (the reference's timed_tuples_to_tuples, data_processing.py:104-131, and
// the bar-segmentation walk of mid_to_bars, :140-176). This is the hot loop
// of offline corpus preprocessing -- the only part of the pipeline where
// SURVEY.md flags a compiled-language component as warranted. Exposed to
// Python through ctypes (ops/native.py); semantics are bit-identical to
// the vectorized numpy codec (tests/test_native.py cross-checks).
//
// Build: g++ -O3 -shared -fPIC -o libmetokenizer.so tokenizer.cc

#include <cstdint>
#include <cmath>

namespace {

constexpr int16_t kTimeshiftEvent = 10;

// round-half-to-even to the step grid, clamped away from zero
// (data_processing.py:122-126: int(step * round(rem / step)) with
// Python banker's rounding, then "do not round to zero")
inline int64_t quantize_remainder(int64_t rem, int step) {
  double x = static_cast<double>(rem) / step;
  double r = std::nearbyint(x);  // default FE_TONEAREST = half-to-even
  int64_t q = static_cast<int64_t>(r) * step;
  if (rem > 0 && q == 0) q = step;
  return q;
}

}  // namespace

extern "C" {

// Tokenize one time-sorted event sequence.
//   n           number of events
//   times_ms    [n] event times in integer milliseconds
//   events      [n] event indices (ignored where special[i] != 0)
//   values      [n] event values
//   special     [n] nonzero marks sentinel rows (contribute timeshifts only)
//   out         [cap*2] int16 (event, value) rows
// Returns the number of rows written, or -1 if cap was too small.
int64_t me_tokenize_events(int64_t n, const int64_t* times_ms,
                           const int16_t* events, const int16_t* values,
                           const uint8_t* special, int max_timeshift,
                           int step, int16_t* out, int64_t cap) {
  if (n <= 0) return 0;
  int64_t cursor = times_ms[0];
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t t = times_ms[i];
    if (t > cursor) {
      int64_t delta = t - cursor;
      int64_t n_full = delta / max_timeshift;
      for (int64_t j = 0; j < n_full; ++j) {
        if (m >= cap) return -1;
        out[2 * m] = kTimeshiftEvent;
        out[2 * m + 1] = static_cast<int16_t>(max_timeshift);
        ++m;
      }
      int64_t rem = delta % max_timeshift;
      if (rem > 0) {
        if (m >= cap) return -1;
        out[2 * m] = kTimeshiftEvent;
        out[2 * m + 1] = static_cast<int16_t>(quantize_remainder(rem, step));
        ++m;
      }
      cursor = t;
    }
    if (!special[i]) {
      if (m >= cap) return -1;
      out[2 * m] = events[i];
      out[2 * m + 1] = values[i];
      ++m;
    }
  }
  return m;
}

// Segment a time-sorted event stream into bars and tokenize each
// (mid_to_bars, data_processing.py:140-176): every bar restarts the clock
// at its downbeat, gets a trailing timeshift to the bar end, and is
// dropped when it holds <= 2 entries including the two boundary sentinels.
//   n_events         event count; times [n] float seconds (pre-rounded to
//                    6 decimals by the caller); events/values [n]
//   n_bars           downbeat count; bar_times [n_bars] float seconds
//                    (the caller appends the two extrapolated end bars)
//   out              [cap*2] int16 rows, bars concatenated
//   bar_lens         [max_bars] int64 per-bar row counts
// Returns the number of bars written, or -1 on overflow.
int64_t me_tokenize_bars(int64_t n_events, const double* times,
                         const int16_t* events, const int16_t* values,
                         int64_t n_bars, const double* bar_times,
                         int max_timeshift, int step, int16_t* out,
                         int64_t cap, int64_t* bar_lens, int64_t max_bars) {
  int64_t i_bar = -1;
  int64_t i_note = 0;
  int64_t out_rows = 0;
  int64_t bars_written = 0;

  // current bar accumulation buffers (times in ms, plus sentinel flags)
  // sized generously; grown via heap if needed
  const int64_t kBuf = 1 << 16;
  static thread_local int64_t t_buf[kBuf];
  static thread_local int16_t e_buf[kBuf];
  static thread_local int16_t v_buf[kBuf];
  static thread_local uint8_t s_buf[kBuf];

  int64_t cur = 0;
  double cur_bar_end_s = -1e300;
  double cur_bar_start_s = 0.0;
  bool have_start = false;

  while (i_note < n_events) {
    double t = times[i_note];
    if (t < cur_bar_end_s) {
      if (cur >= kBuf) return -1;
      t_buf[cur] = static_cast<int64_t>(std::nearbyint(t * 1000.0));
      e_buf[cur] = events[i_note];
      v_buf[cur] = values[i_note];
      s_buf[cur] = 0;
      ++cur;
      ++i_note;
    } else {
      // close the current bar with the BAR_END sentinel
      if (have_start || cur > 0) {
        if (cur >= kBuf) return -1;
        t_buf[cur] = static_cast<int64_t>(std::nearbyint(cur_bar_end_s * 1000.0));
        e_buf[cur] = 0;
        v_buf[cur] = 0;
        s_buf[cur] = 1;
        ++cur;
        if (cur > 2) {
          if (bars_written >= max_bars) return -1;
          int64_t rows = me_tokenize_events(
              cur, t_buf, e_buf, v_buf, s_buf, max_timeshift, step,
              out + 2 * out_rows, cap - out_rows);
          if (rows < 0) return -1;
          bar_lens[bars_written++] = rows;
          out_rows += rows;
        }
      }
      ++i_bar;
      if (i_bar + 1 >= n_bars) return -2;  // ran past the bar table
      cur_bar_start_s = bar_times[i_bar];
      cur_bar_end_s = bar_times[i_bar + 1];
      // open next bar with the BAR_START sentinel
      t_buf[0] = static_cast<int64_t>(std::nearbyint(cur_bar_start_s * 1000.0));
      e_buf[0] = 0;
      v_buf[0] = 0;
      s_buf[0] = 1;
      cur = 1;
      have_start = true;
    }
  }
  return bars_written;
}

}  // extern "C"
