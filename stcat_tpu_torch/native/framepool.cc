// Native subprocess-pipe reader pool for the video decode data plane.
//
// Rationale: the input pipeline shells out to ffmpeg for raw RGB frames
// (ref datasets/vidstg.py:112-152 via ffmpeg-python). In Python, draining a
// multi-hundred-MB pipe holds the GIL for the copy and serializes decode
// against transform work. This pool runs popen + drain entirely in C++
// worker threads: Python submits a command line and a size bound, later
// collects a pointer to the filled buffer (zero-copy into numpy via ctypes).
//
// C ABI (consumed by stcat_tpu_torch/data/native_decode.py through ctypes):
//   fp_create(workers)                  -> pool*
//   fp_submit(pool, cmd, max_bytes)     -> ticket (>=0) | -1
//   fp_wait(pool, ticket, &ptr, &size)  -> 0 ok | <0 error (blocks)
//   fp_release(pool, ticket)            frees the buffer
//   fp_destroy(pool)
//
// Build: g++ -O2 -fPIC -shared framepool.cc -o libframepool-<hash>.so -lpthread,
// at first use, into stcat_tpu_torch/_build/ (kernels/_build.py:build_native).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Job {
  std::string cmd;
  size_t cap = 0;
  std::vector<uint8_t> data;
  long size = -1;       // bytes read; -1 until done
  int exit_code = -1;
  bool done = false;
};

struct Pool {
  std::mutex mu;
  std::condition_variable cv_submit;  // workers wait for jobs
  std::condition_variable cv_done;    // waiters wait for completion
  std::deque<long> queue;
  std::unordered_map<long, std::unique_ptr<Job>> jobs;
  std::vector<std::thread> workers;
  long next_ticket = 0;
  bool stopping = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      long ticket;
      Job* job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [&] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        ticket = queue.front();
        queue.pop_front();
        job = jobs.at(ticket).get();
      }
      execute(job);
      {
        std::lock_guard<std::mutex> lk(mu);
        job->done = true;
      }
      cv_done.notify_all();
    }
  }

  static void execute(Job* job) {
    job->data.resize(job->cap);
    FILE* pipe = popen(job->cmd.c_str(), "r");
    if (pipe == nullptr) {
      job->size = -2;
      return;
    }
    size_t off = 0;
    while (off < job->cap) {
      size_t n = fread(job->data.data() + off, 1, job->cap - off, pipe);
      if (n == 0) break;
      off += n;
    }
    // drain any excess so pclose gets a clean exit
    uint8_t sink[4096];
    while (fread(sink, 1, sizeof(sink), pipe) > 0) {
    }
    job->exit_code = pclose(pipe);
    job->size = static_cast<long>(off);
  }
};

}  // namespace

extern "C" {

void* fp_create(int workers) {
  if (workers < 1) workers = 1;
  return new Pool(workers);
}

long fp_submit(void* pool_ptr, const char* cmd, long max_bytes) {
  auto* pool = static_cast<Pool*>(pool_ptr);
  if (cmd == nullptr || max_bytes <= 0) return -1;
  auto job = std::make_unique<Job>();
  job->cmd = cmd;
  job->cap = static_cast<size_t>(max_bytes);
  long ticket;
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    ticket = pool->next_ticket++;
    pool->jobs.emplace(ticket, std::move(job));
    pool->queue.push_back(ticket);
  }
  pool->cv_submit.notify_one();
  return ticket;
}

long fp_wait(void* pool_ptr, long ticket, uint8_t** out_ptr, long* out_size) {
  auto* pool = static_cast<Pool*>(pool_ptr);
  std::unique_lock<std::mutex> lk(pool->mu);
  auto it = pool->jobs.find(ticket);
  if (it == pool->jobs.end()) return -1;
  Job* job = it->second.get();
  pool->cv_done.wait(lk, [&] { return job->done; });
  if (job->size < 0) return -2;
  *out_ptr = job->data.data();
  *out_size = job->size;
  return job->exit_code == 0 ? 0 : -3;
}

void fp_release(void* pool_ptr, long ticket) {
  auto* pool = static_cast<Pool*>(pool_ptr);
  std::lock_guard<std::mutex> lk(pool->mu);
  pool->jobs.erase(ticket);
}

void fp_destroy(void* pool_ptr) {
  auto* pool = static_cast<Pool*>(pool_ptr);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->stopping = true;
  }
  pool->cv_submit.notify_all();
  for (auto& t : pool->workers) t.join();
  delete pool;
}

}  // extern "C"
