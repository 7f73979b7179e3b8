// Native concurrency stress test for batcher.cc, the port's copy of the
// reference's test. ops/build.py builds it plain and under
// -fsanitize=thread (`build.run_host_test('batcher_test', variant)`).
// Exercises the full lifecycle under real thread contention: many
// callers, one computation thread, timeout flushes, max-size splits, an
// error batch, then close() with callers still parked. Exits 0 on
// success; a TSAN report (TSAN_OPTIONS=halt_on_error=1) fails the run.

#include <atomic>
#include <cassert>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

using i64 = long long;

extern "C" {
void* batcher_create(i64, i64, i64, i64);
i64 batcher_compute_begin(void*, const void**, const i64*, i64, i64*);
i64 batcher_compute_wait(void*, i64, char*, i64);
i64 batcher_result_size(void*, i64, i64);
i64 batcher_result_copy(void*, i64, i64, void*, i64);
void batcher_request_free(void*, i64);
i64 batcher_get_batch(void*, i64*, i64*);
i64 batcher_batch_input_copy(void*, i64, i64, void*);
i64 batcher_set_outputs(void*, i64, i64, const void**, const i64*, i64);
i64 batcher_set_error(void*, i64, const char*);
void batcher_close(void*);
void batcher_destroy(void*);
}

namespace {

constexpr int kCallers = 32;
constexpr int kCallsPerCaller = 50;
std::atomic<int> ok_count{0};
std::atomic<int> err_count{0};
std::atomic<int> cancelled_count{0};

void caller(void* h, int tid) {
  for (int i = 0; i < kCallsPerCaller; ++i) {
    double v = tid * 1000 + i;
    const void* data[1] = {&v};
    i64 row_bytes[1] = {sizeof(double)};
    i64 req = 0;
    i64 rc = batcher_compute_begin(h, data, row_bytes, 1, &req);
    if (rc == 5 /*RC_CLOSED*/) {
      cancelled_count++;
      return;
    }
    assert(rc == 0);
    char err[256];
    rc = batcher_compute_wait(h, req, err, sizeof(err));
    if (rc == 0) {
      double out = 0;
      assert(batcher_result_size(h, req, 0) == (i64)sizeof(double));
      assert(batcher_result_copy(h, req, 0, &out, sizeof(double)) == 0);
      assert(out == v * 2);
      ok_count++;
    } else if (rc == 1) {
      assert(std::strcmp(err, "test error") == 0);
      err_count++;
    } else {
      assert(rc == 2);
      cancelled_count++;
      batcher_request_free(h, req);
      return;
    }
    batcher_request_free(h, req);
  }
}

void computation_loop(void* h) {
  int batch_no = 0;
  for (;;) {
    i64 batch_id = 0, rows = 0;
    i64 rc = batcher_get_batch(h, &batch_id, &rows);
    if (rc == 5 /*RC_CLOSED*/) return;
    assert(rc == 0 && rows >= 1);
    std::vector<double> in(rows);
    batcher_batch_input_copy(h, batch_id, 0, in.data());
    if (++batch_no % 97 == 0) {  // occasionally fail a whole batch
      batcher_set_error(h, batch_id, "test error");
      continue;
    }
    std::vector<double> out(rows);
    for (i64 i = 0; i < rows; ++i) out[i] = in[i] * 2;
    const void* data[1] = {out.data()};
    i64 row_bytes[1] = {sizeof(double)};
    rc = batcher_set_outputs(h, batch_id, 1, data, row_bytes, rows);
    assert(rc == 0 || rc == 6 /*batch cancelled by close*/);
  }
}

}  // namespace

int main() {
  // Phase 1: full run to completion.
  {
    void* h = batcher_create(8, 16, 2, 1);
    std::thread comp(computation_loop, h);
    std::vector<std::thread> callers;
    for (int t = 0; t < kCallers; ++t) callers.emplace_back(caller, h, t);
    for (auto& t : callers) t.join();
    batcher_close(h);
    comp.join();
    batcher_destroy(h);
    std::printf("phase1: ok=%d err=%d cancelled=%d\n", ok_count.load(),
                err_count.load(), cancelled_count.load());
    assert(ok_count + err_count == kCallers * kCallsPerCaller);
  }

  // Phase 2: close() while callers are parked (min never reached).
  {
    ok_count = err_count = cancelled_count = 0;
    void* h = batcher_create(1000, 0, 60000, 1);
    std::vector<std::thread> callers;
    for (int t = 0; t < 8; ++t) callers.emplace_back(caller, h, t);
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    batcher_close(h);
    for (auto& t : callers) t.join();
    batcher_destroy(h);
    std::printf("phase2: cancelled=%d\n", cancelled_count.load());
    assert(cancelled_count == 8);
  }
  std::printf("batcher_test: PASS\n");
  return 0;
}
