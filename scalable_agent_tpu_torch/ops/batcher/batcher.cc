// Host-side dynamic request batcher (C ABI, consumed via ctypes).
//
// The PyTorch port's own copy of scalable_agent_tpu/ops/batcher/batcher.cc
// (the same code and C interface): many caller threads each submit a small
// batch of rows and block; a single computation thread receives merged
// batches (concatenated along dim 0 when >= minimum size or after
// timeout_ms, capped at maximum), runs the batched function (the port's
// inference step on the card), and returns per-caller slices. Errors
// propagate to exactly the affected batch's callers; close() cancels all
// waiters. It is host code, not a device kernel.
//
// Synchronization: one mutex + two condition_variables (caller-side and
// batcher-side). Tensors are opaque byte rows — dtype/shape handling
// stays in Python; C++ owns buffering, merging, splitting and wakeups.
//
// Build: ops/build.py compiles it at first use with
// `g++ -std=c++17 -O2 -fPIC -shared -pthread` into
// scalable_agent_tpu_torch/_build/ under a digest name.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace {

using i64 = long long;
using Clock = std::chrono::steady_clock;

enum ReqState { PENDING, IN_BATCH, DONE, ERROR, CANCELLED };

// Return codes (mirrored in the Python wrapper).
enum Rc {
  RC_OK = 0,
  RC_ERROR = 1,      // computation failed; message available
  RC_CANCELLED = 2,  // batcher closed while waiting
  RC_SHAPE = 3,      // row size mismatch vs. first request
  RC_TOO_BIG = 4,    // rows > maximum_batch_size
  RC_CLOSED = 5,     // submitted/polled after close
  RC_BAD_ID = 6,     // unknown request/batch id
  RC_SIZE = 7,       // set_outputs rows != batch rows
};

struct Request {
  i64 id = 0;
  i64 rows = 0;
  ReqState state = PENDING;
  Clock::time_point enqueue_time;
  std::vector<std::vector<char>> inputs;   // one buffer per tensor
  std::vector<std::vector<char>> outputs;  // filled by set_outputs split
  std::string error;
};

struct Batch {
  i64 id = 0;
  i64 total_rows = 0;
  std::vector<i64> req_ids;
  std::vector<i64> req_rows;
  bool delivered = false;  // handed to the computation thread
};

struct Batcher {
  std::mutex mu;
  std::condition_variable caller_cv;   // requests: DONE/ERROR/CANCELLED
  std::condition_variable batcher_cv;  // computation thread: work ready

  i64 min_rows, max_rows, timeout_ms, num_tensors;
  bool closed = false;

  i64 next_req_id = 1;
  i64 next_batch_id = 1;

  std::vector<i64> input_row_bytes;  // fixed by the first request
  std::deque<i64> pending;           // FIFO of request ids
  i64 pending_rows = 0;
  std::map<i64, Request> requests;
  std::map<i64, Batch> batches;
};

Batcher* H(void* h) { return static_cast<Batcher*>(h); }

void cancel_request_locked(Request& r) {
  if (r.state == PENDING || r.state == IN_BATCH) {
    r.state = CANCELLED;
  }
}

}  // namespace

extern "C" {

void* batcher_create(i64 min_rows, i64 max_rows, i64 timeout_ms,
                     i64 num_tensors) {
  auto* b = new Batcher();
  b->min_rows = min_rows < 1 ? 1 : min_rows;
  b->max_rows = max_rows;
  b->timeout_ms = timeout_ms;
  b->num_tensors = num_tensors;
  b->input_row_bytes.assign(num_tensors, -1);
  return b;
}

// Caller side ---------------------------------------------------------

// Enqueue `rows` rows of `num_tensors` tensors. data[i] points at
// rows*row_bytes[i] bytes. On success *req_id_out identifies the
// request for wait/result/free.
i64 batcher_compute_begin(void* h, const void** data,
                          const i64* row_bytes, i64 rows,
                          i64* req_id_out) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  if (b->closed) return RC_CLOSED;
  if (rows < 1 || (b->max_rows > 0 && rows > b->max_rows))
    return RC_TOO_BIG;
  for (i64 i = 0; i < b->num_tensors; ++i) {
    if (b->input_row_bytes[i] < 0) {
      b->input_row_bytes[i] = row_bytes[i];
    } else if (b->input_row_bytes[i] != row_bytes[i]) {
      return RC_SHAPE;
    }
  }
  i64 id = b->next_req_id++;
  Request& r = b->requests[id];
  r.id = id;
  r.rows = rows;
  r.enqueue_time = Clock::now();
  r.inputs.resize(b->num_tensors);
  for (i64 i = 0; i < b->num_tensors; ++i) {
    const char* src = static_cast<const char*>(data[i]);
    r.inputs[i].assign(src, src + rows * row_bytes[i]);
  }
  b->pending.push_back(id);
  b->pending_rows += rows;
  *req_id_out = id;
  b->batcher_cv.notify_all();
  return RC_OK;
}

// Block until the request resolves. RC_OK: results readable.
// RC_ERROR: message copied into err_buf. RC_CANCELLED: batcher closed.
i64 batcher_compute_wait(void* h, i64 req_id, char* err_buf,
                         i64 err_buf_len) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->requests.find(req_id);
  if (it == b->requests.end()) return RC_BAD_ID;
  Request& r = it->second;
  b->caller_cv.wait(lock, [&] {
    return r.state == DONE || r.state == ERROR || r.state == CANCELLED;
  });
  if (r.state == DONE) return RC_OK;
  if (r.state == ERROR) {
    if (err_buf && err_buf_len > 0) {
      std::snprintf(err_buf, err_buf_len, "%s", r.error.c_str());
    }
    return RC_ERROR;
  }
  return RC_CANCELLED;
}

i64 batcher_result_count(void* h, i64 req_id) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->requests.find(req_id);
  if (it == b->requests.end()) return -1;
  return static_cast<i64>(it->second.outputs.size());
}

i64 batcher_result_size(void* h, i64 req_id, i64 tensor_idx) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->requests.find(req_id);
  if (it == b->requests.end()) return -1;
  auto& outs = it->second.outputs;
  if (tensor_idx < 0 || tensor_idx >= (i64)outs.size()) return -1;
  return static_cast<i64>(outs[tensor_idx].size());
}

// Copies at most `capacity` bytes — the caller sizes dst from its own
// metadata, which can lag the stored output if the batched function's
// trailing shape varies across batches; never overrun the caller.
i64 batcher_result_copy(void* h, i64 req_id, i64 tensor_idx, void* dst,
                        i64 capacity) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->requests.find(req_id);
  if (it == b->requests.end()) return RC_BAD_ID;
  auto& outs = it->second.outputs;
  if (tensor_idx < 0 || tensor_idx >= (i64)outs.size()) return RC_BAD_ID;
  i64 size = static_cast<i64>(outs[tensor_idx].size());
  if (capacity < size) return RC_SIZE;
  std::memcpy(dst, outs[tensor_idx].data(), size);
  return RC_OK;
}

void batcher_request_free(void* h, i64 req_id) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  b->requests.erase(req_id);
}

// Computation-thread side --------------------------------------------

// Block until a batch is ready (>= min rows, or timeout_ms after the
// oldest pending request, or close). RC_OK: *batch_id/*total_rows set.
// RC_CLOSED: batcher closed and nothing pending.
i64 batcher_get_batch(void* h, i64* batch_id, i64* total_rows) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  for (;;) {
    if (b->pending_rows > 0) {
      bool full = b->pending_rows >= b->min_rows;
      auto& oldest = b->requests[b->pending.front()];
      auto deadline =
          oldest.enqueue_time + std::chrono::milliseconds(b->timeout_ms);
      if (full || Clock::now() >= deadline) {
        // Pop FIFO up to max_rows (never splitting one request).
        Batch batch;
        batch.id = b->next_batch_id++;
        while (!b->pending.empty()) {
          i64 rid = b->pending.front();
          Request& r = b->requests[rid];
          if (b->max_rows > 0 &&
              batch.total_rows + r.rows > b->max_rows &&
              batch.total_rows > 0)
            break;
          b->pending.pop_front();
          b->pending_rows -= r.rows;
          r.state = IN_BATCH;
          batch.req_ids.push_back(rid);
          batch.req_rows.push_back(r.rows);
          batch.total_rows += r.rows;
        }
        *batch_id = batch.id;
        *total_rows = batch.total_rows;
        b->batches[batch.id] = std::move(batch);
        return RC_OK;
      }
      b->batcher_cv.wait_until(lock, deadline);
      continue;
    }
    if (b->closed) return RC_CLOSED;
    b->batcher_cv.wait(lock);
  }
}

// Concatenate the batch's rows for one input tensor into dst
// (total_rows * row_bytes bytes).
i64 batcher_batch_input_copy(void* h, i64 batch_id, i64 tensor_idx,
                             void* dst) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->batches.find(batch_id);
  if (it == b->batches.end()) return RC_BAD_ID;
  if (tensor_idx < 0 || tensor_idx >= b->num_tensors) return RC_BAD_ID;
  char* out = static_cast<char*>(dst);
  for (i64 rid : it->second.req_ids) {
    auto& buf = b->requests[rid].inputs[tensor_idx];
    std::memcpy(out, buf.data(), buf.size());
    out += buf.size();
  }
  return RC_OK;
}

// Split `num_outputs` tensors of total_rows rows back to the batch's
// requests (row_bytes[i] bytes per row of output i) and wake them.
// Requests cancelled in the meantime are skipped.
i64 batcher_set_outputs(void* h, i64 batch_id, i64 num_outputs,
                        const void** data, const i64* row_bytes,
                        i64 total_rows) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->batches.find(batch_id);
  if (it == b->batches.end()) return RC_BAD_ID;
  Batch& batch = it->second;
  if (total_rows != batch.total_rows) return RC_SIZE;
  i64 offset_rows = 0;
  for (size_t k = 0; k < batch.req_ids.size(); ++k) {
    i64 rid = batch.req_ids[k];
    i64 rows = batch.req_rows[k];
    auto rit = b->requests.find(rid);
    if (rit != b->requests.end() && rit->second.state == IN_BATCH) {
      Request& r = rit->second;
      r.outputs.resize(num_outputs);
      for (i64 i = 0; i < num_outputs; ++i) {
        const char* src = static_cast<const char*>(data[i]) +
                          offset_rows * row_bytes[i];
        r.outputs[i].assign(src, src + rows * row_bytes[i]);
      }
      r.state = DONE;
    }
    offset_rows += rows;
  }
  b->batches.erase(it);
  b->caller_cv.notify_all();
  return RC_OK;
}

// Fail every request in the batch with `msg`.
i64 batcher_set_error(void* h, i64 batch_id, const char* msg) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  auto it = b->batches.find(batch_id);
  if (it == b->batches.end()) return RC_BAD_ID;
  for (i64 rid : it->second.req_ids) {
    auto rit = b->requests.find(rid);
    if (rit != b->requests.end() && rit->second.state == IN_BATCH) {
      rit->second.state = ERROR;
      rit->second.error = msg ? msg : "unknown error";
    }
  }
  b->batches.erase(it);
  b->caller_cv.notify_all();
  return RC_OK;
}

// Cancel all pending/in-flight requests; wake everyone. get_batch
// returns RC_CLOSED once the queue drains.
void batcher_close(void* h) {
  Batcher* b = H(h);
  std::unique_lock<std::mutex> lock(b->mu);
  b->closed = true;
  for (auto& kv : b->requests) cancel_request_locked(kv.second);
  b->pending.clear();
  b->pending_rows = 0;
  b->batches.clear();
  b->caller_cv.notify_all();
  b->batcher_cv.notify_all();
}

void batcher_destroy(void* h) { delete H(h); }

}  // extern "C"
