// Native timeline writer: this package's copy of the JAX package's
// horovod_tpu/csrc/timeline.cc (reference horovod/common/timeline.{h,cc}).
// The background loop must never block on profile IO, so records cross
// a queue to a dedicated writer thread that serializes Chrome-tracing
// JSON (the reference uses a boost lock-free SPSC queue + writer thread,
// timeline.h:47-75).  Built at first use with g++ into
// horovod_tpu_torch/_build/libhvdtorchtl_<hash>.so.
//
// Unlike the JAX package's copy, records arrive in batches: the Python
// side stamps each event and appends it to a list, and hands the list
// over once per background cycle (one foreign call per event cost the
// eager step more than the writer's work, mostly in the interpreter
// lock's hand-offs between the framework and background threads).
//
// C ABI consumed by horovod_tpu_torch/runtime/timeline.py via ctypes:
//   hvd_tl_open(path)                     -> handle (0 on failure)
//   hvd_tl_events(h, n, ts, phases, tensors, names)
//                                         -> n records: ts[i] in us, phase
//                                            'B'/'E'/'i', tensor and name
//                                            n NUL-terminated strings each
//                                            (an empty tensor: a global
//                                            instant marker)
//   hvd_tl_close(h)                       -> drain, write footer, free

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace {

struct Record {
  std::string tensor;   // empty for markers
  std::string name;
  char phase;           // 'B', 'E', or 'i' (marker)
  int64_t ts_us;
  bool stop = false;
};

std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

class Timeline {
 public:
  explicit Timeline(const char* path) : file_(std::fopen(path, "w")) {
    if (!file_) return;
    std::fputs("[\n", file_);
    writer_ = std::thread([this] { WriteLoop(); });
  }

  bool ok() const { return file_ != nullptr; }

  void PushBatch(std::deque<Record>* batch) {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (closed_) return;  // after the footer: dropped
      for (auto& r : *batch) q_.push_back(std::move(r));
    }
    cv_.notify_one();
  }

  void Close() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (closed_) return;
      closed_ = true;
      Record stop;
      stop.stop = true;
      q_.push_back(std::move(stop));
    }
    cv_.notify_one();
    if (writer_.joinable()) writer_.join();
  }

  ~Timeline() { Close(); }

 private:
  void Emit(const Record& r) {
    // tid per tensor row, announced once via a metadata event
    // (reference timeline.cc SetPidAndTid equivalent)
    int tid = 0;
    if (!r.tensor.empty()) {
      auto it = tids_.find(r.tensor);
      if (it == tids_.end()) {
        tid = (int)tids_.size() + 1;
        tids_.emplace(r.tensor, tid);
        Sep();
        std::fprintf(file_,
                     "{\"name\": \"thread_name\", \"ph\": \"M\", "
                     "\"pid\": 0, \"tid\": %d, \"args\": {\"name\": "
                     "\"%s\"}}",
                     tid, json_escape(r.tensor).c_str());
      } else {
        tid = it->second;
      }
    }
    Sep();
    if (r.phase == 'i') {
      // tensor-scoped instants (per-rank negotiation ticks) land on the
      // tensor's row; tensor-less instants are global cycle markers
      std::fprintf(file_,
                   "{\"name\": \"%s\", \"ph\": \"i\", \"pid\": 0, "
                   "\"tid\": %d, \"ts\": %lld, \"s\": \"%s\"}",
                   json_escape(r.name).c_str(), r.tensor.empty() ? 0 : tid,
                   (long long)r.ts_us, r.tensor.empty() ? "g" : "t");
    } else {
      std::fprintf(file_,
                   "{\"name\": \"%s\", \"ph\": \"%c\", \"pid\": 0, "
                   "\"tid\": %d, \"ts\": %lld}",
                   json_escape(r.name).c_str(), r.phase, tid,
                   (long long)r.ts_us);
    }
  }

  void Sep() {
    if (first_) {
      first_ = false;
    } else {
      std::fputs(",\n", file_);
    }
  }

  void WriteLoop() {
    for (;;) {
      std::deque<Record> batch;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return !q_.empty(); });
        batch.swap(q_);
      }
      for (auto& r : batch) {
        if (r.stop) {
          std::fputs("\n]\n", file_);
          std::fclose(file_);
          file_ = nullptr;
          return;
        }
        Emit(r);
      }
      std::fflush(file_);
    }
  }

  FILE* file_;
  std::thread writer_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Record> q_;
  bool closed_ = false;
  // writer-thread-only state:
  std::unordered_map<std::string, int> tids_;
  bool first_ = true;
};

}  // namespace

extern "C" {

void* hvd_tl_open(const char* path) {
  auto* tl = new Timeline(path);
  if (!tl->ok()) {
    delete tl;
    return nullptr;
  }
  return tl;
}

void hvd_tl_events(void* h, int64_t n, const int64_t* ts,
                   const char* phases, const char* tensors,
                   const char* names) {
  auto* tl = static_cast<Timeline*>(h);
  std::deque<Record> batch;
  for (int64_t i = 0; i < n; ++i) {
    Record r;
    r.tensor = tensors;
    tensors += r.tensor.size() + 1;
    r.name = names;
    names += r.name.size() + 1;
    r.phase = phases[i];
    r.ts_us = ts[i];
    batch.push_back(std::move(r));
  }
  tl->PushBatch(&batch);
}

void hvd_tl_close(void* h) {
  auto* tl = static_cast<Timeline*>(h);
  tl->Close();
  delete tl;
}

}  // extern "C"
