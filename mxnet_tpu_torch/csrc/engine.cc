// Native dependency engine of the PyTorch/CUDA port: the port's own copy of
// cpp/engine.cc (reference: src/engine/threaded_engine.cc,
// threaded_engine_perdevice.cc — re-designed, not translated), built by
// mxnet_tpu_torch/_native.py with g++ into mxnet_tpu_torch/_build/.
//
// Role: CUDA streams own on-device scheduling, so this engine
// schedules HOST-side async work (data pipeline, IO, serialisation) with the
// same read/write-variable dependency semantics MXNet's ThreadedEngine gives
// kernels:
//   * ops that READ a var run concurrently with other readers;
//   * an op that WRITES a var waits for all prior readers+writer and blocks
//     later ops until it completes (program order per var);
//   * WaitForVar blocks until every op touching the var so far is done;
//   * WaitForAll blocks until the engine drains.
//
// QoS: ready ops dispatch by PRIORITY CLASS, not FIFO — class 0
// ("high", e.g. serve decode turns) preempts queued class-1 ("normal") and
// class-2 ("background", prefetch/checkpoint) work at dispatch time. Ops
// already running are never interrupted. Starvation is bounded by AGING:
// a queued op's effective class drops by one for every `aging_ms_` it has
// waited, floored at class 0 — promoted background work beats fresh
// normal work (ties among promoted classes go to the longest waiter)
// while the native high class wins its ties, keeping high-priority
// dispatch latency bounded under any backlog. Admission (bounded queues,
// deadlines, task groups) lives in the Python facade (mxnet_tpu_torch/engine.py)
// so both engine implementations share one policy; this file only orders
// the ready queue.
//
// Debug mode (MXTPU_ENGINE_DEBUG=1 or MXTPUEngineSetDebug) is the race /
// deadlock detector (reference: the ENGINE_DEBUG checks + NaiveEngine
// cross-validation story of threaded_engine):
//   * write-write / read-write hazard detection — per-var running-state
//     invariants (at most one running writer, never writer+readers) are
//     verified at every release and on demand via MXTPUEngineDebugCheck.
//     MXTPUEngineDebugBypassPush schedules an op WITHOUT dependency
//     admission, simulating a buggy scheduler so tests can provoke a real
//     concurrent-writer hazard and watch the detector catch it.
//   * deadlock detection — an op that lists the same var as both read and
//     write would wait on itself forever (admission admits the read, then
//     queues the write behind it). Debug mode records the cycle and drops
//     the redundant read dep so the program stays live. Dependency cycles
//     ACROSS ops cannot form by construction: Push acquires all vars
//     atomically in program order, so every wait edge points to an
//     earlier-pushed op (verified by a queue seq-monotonicity assert).
//   * stall watchdog — MXTPUEngineWaitAllFor(ms) returns nonzero instead
//     of blocking forever when the engine cannot drain.
// Errors are recorded (MXTPUEngineLastError), not aborted, so the Python
// layer can raise.
//
// Exposed as a plain C ABI consumed via ctypes (mxnet_tpu_torch/_native.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Op;

struct VarState {
  std::deque<std::pair<Op*, bool>> queue;  // (op, is_write) in program order
  int running_reads = 0;
  int running_writes = 0;  // int, not bool: debug mode must SEE a double-admit
};

constexpr int kClasses = 3;  // 0 = high, 1 = normal, 2 = background

struct Op {
  void (*fn)(void*);
  void* arg;
  std::vector<uint64_t> reads;
  std::vector<uint64_t> writes;
  uint64_t seq = 0;
  int pri = 1;
  std::chrono::steady_clock::time_point enq;  // set when the op turns READY
  std::atomic<int> wait{0};
};

class Engine {
 public:
  explicit Engine(int workers) : workers_(workers > 0 ? workers : 1) {
    const char* dbg = std::getenv("MXTPU_ENGINE_DEBUG");
    debug_ = dbg && dbg[0] && std::strcmp(dbg, "0") != 0;
    const char* aging = std::getenv("MXTPU_ENGINE_AGING_MS");
    if (aging && aging[0]) {
      // strtol + endptr: a malformed value must keep the 100ms default
      // (parity with _PyEngine's ValueError fallback) — atoi would
      // return 0 and silently disable aging. An explicit "0" disables.
      char* end = nullptr;
      long ms = std::strtol(aging, &end, 10);
      if (end != aging && *end == '\0' && ms >= 0 && ms <= INT32_MAX)
        aging_ms_.store(static_cast<int>(ms));
    }
    for (int i = 0; i < workers_; ++i)
      threads_.emplace_back([this] { WorkerLoop(); });
  }

  ~Engine() {
    {
      std::unique_lock<std::mutex> lk(ready_mu_);
      shutdown_ = true;
    }
    ready_cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  uint64_t NewVar() {
    std::unique_lock<std::mutex> lk(vars_mu_);
    uint64_t id = next_var_++;
    vars_.emplace(id, VarState{});
    return id;
  }

  void DelVar(uint64_t v) {
    // deferred: only erase when idle on that var (caller guarantees no
    // in-flight ops, matching Engine::DeleteVariable semantics)
    std::unique_lock<std::mutex> lk(vars_mu_);
    auto it = vars_.find(v);
    if (it != vars_.end() && it->second.queue.empty() &&
        it->second.running_reads == 0 && it->second.running_writes == 0)
      vars_.erase(it);
  }

  void Push(void (*fn)(void*), void* arg, const uint64_t* reads, int nreads,
            const uint64_t* writes, int nwrites, int pri = 1) {
    Op* op = new Op();
    op->fn = fn;
    op->arg = arg;
    op->pri = pri < 0 ? 0 : (pri >= kClasses ? kClasses - 1 : pri);
    op->reads.assign(reads, reads + nreads);
    op->writes.assign(writes, writes + nwrites);
    // self-dependency = guaranteed deadlock (read admits, write queues
    // behind it, op waits on itself): ALWAYS drop the redundant read dep
    // (a write already orders after all prior readers); debug mode also
    // reports the cycle so the caller can fix their dependency lists
    {
      std::vector<uint64_t> cleaned;
      for (uint64_t r : op->reads) {
        bool also_written = false;
        for (uint64_t w : op->writes) also_written |= (w == r);
        if (!also_written)
          cleaned.push_back(r);
        else if (debug_)
          RecordError("deadlock: op reads AND writes var " +
                      std::to_string(r) +
                      " (self-dependency cycle; read dep dropped)");
      }
      op->reads.swap(cleaned);
    }
    pending_.fetch_add(1);
    // wait on every var; each var either admits the op now or queues it
    op->wait.store(static_cast<int>(op->reads.size() + op->writes.size()) +
                   1);  // +1 guard against races below
    {
      std::unique_lock<std::mutex> lk(vars_mu_);
      op->seq = next_seq_++;
      for (uint64_t v : op->reads) AdmitOrQueue(op, v, /*is_write=*/false);
      for (uint64_t v : op->writes) AdmitOrQueue(op, v, /*is_write=*/true);
    }
    FinishDep(op);  // drop the guard
  }

  // Debug only: schedule WITHOUT dependency admission — simulates a buggy
  // scheduler so tests can provoke a real write-write hazard.
  void DebugBypassPush(void (*fn)(void*), void* arg, const uint64_t* reads,
                       int nreads, const uint64_t* writes, int nwrites) {
    Op* op = new Op();
    op->fn = fn;
    op->arg = arg;
    op->reads.assign(reads, reads + nreads);
    op->writes.assign(writes, writes + nwrites);
    pending_.fetch_add(1);
    {
      std::unique_lock<std::mutex> lk(vars_mu_);
      for (uint64_t v : op->reads) ++vars_[v].running_reads;
      for (uint64_t v : op->writes) ++vars_[v].running_writes;
    }
    DebugCheck();
    Enqueue(op);
  }

  void WaitForVar(uint64_t v) {
    std::unique_lock<std::mutex> lk(vars_mu_);
    idle_cv_.wait(lk, [&] {
      auto it = vars_.find(v);
      if (it == vars_.end()) return true;
      const VarState& s = it->second;
      return s.queue.empty() && s.running_reads == 0 &&
             s.running_writes == 0;
    });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(vars_mu_);
    idle_cv_.wait(lk, [&] { return pending_.load() == 0; });
  }

  // 0 = drained; 1 = timed out with work still pending (stall/deadlock)
  int WaitAllFor(int timeout_ms) {
    std::unique_lock<std::mutex> lk(vars_mu_);
    bool ok = idle_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                [&] { return pending_.load() == 0; });
    if (!ok)
      RecordErrorLocked(
          "stall: engine did not drain within " +
          std::to_string(timeout_ms) + "ms with " +
          std::to_string(pending_.load()) + " op(s) pending");
    return ok ? 0 : 1;
  }

  // 0 = invariants hold; 1 = hazard recorded
  int DebugCheck() {
    std::unique_lock<std::mutex> lk(vars_mu_);
    int bad = 0;
    for (auto& [id, s] : vars_) {
      if (s.running_writes > 1) {
        RecordErrorLocked("write-write hazard: var " + std::to_string(id) +
                          " has " + std::to_string(s.running_writes) +
                          " concurrent writers");
        bad = 1;
      }
      if (s.running_writes > 0 && s.running_reads > 0) {
        RecordErrorLocked("read-write hazard: var " + std::to_string(id) +
                          " has a writer and " +
                          std::to_string(s.running_reads) +
                          " reader(s) running concurrently");
        bad = 1;
      }
      if (s.running_writes < 0 || s.running_reads < 0) {
        RecordErrorLocked("release underflow on var " + std::to_string(id));
        bad = 1;
      }
    }
    return bad;
  }

  void SetDebug(bool on) { debug_ = on; }
  bool debug() const { return debug_; }

  void SetAgingMs(int ms) {
    if (ms >= 0) aging_ms_.store(ms);
  }
  int aging_ms() const { return aging_ms_.load(); }

  const char* LastError() {
    // thread_local snapshot: the pointer stays valid on THIS thread until
    // its next LastError() call — concurrent callers cannot invalidate it
    // (a shared member snapshot would be a use-after-free under races)
    static thread_local std::string snapshot;
    std::unique_lock<std::mutex> lk(err_mu_);
    snapshot = last_error_;
    return snapshot.c_str();
  }

  void ClearError() {
    std::unique_lock<std::mutex> lk(err_mu_);
    last_error_.clear();
  }

  int workers() const { return workers_; }

 private:
  // vars_mu_ must be held
  void AdmitOrQueue(Op* op, uint64_t v, bool is_write) {
    VarState& s = vars_[v];
    if (debug_ && !s.queue.empty() && s.queue.back().first->seq >= op->seq) {
      // proof obligation for deadlock-freedom: per-var queues are in push
      // order, so wait edges always point to earlier ops (acyclic)
      RecordErrorLocked("queue order violation on var " + std::to_string(v) +
                        " (wait-graph acyclicity broken)");
    }
    bool can_run = s.queue.empty() && s.running_writes == 0 &&
                   (!is_write || s.running_reads == 0);
    if (can_run) {
      if (is_write)
        ++s.running_writes;
      else
        ++s.running_reads;
      FinishDepLocked(op);
    } else {
      s.queue.emplace_back(op, is_write);
    }
  }

  void FinishDep(Op* op) {
    if (op->wait.fetch_sub(1) == 1) Enqueue(op);
  }

  void FinishDepLocked(Op* op) { FinishDep(op); }

  void Enqueue(Op* op) {
    op->enq = std::chrono::steady_clock::now();
    {
      std::unique_lock<std::mutex> lk(ready_mu_);
      ready_[op->pri].push_back(op);
    }
    ready_cv_.notify_one();
  }

  // ready_mu_ must be held
  bool AnyReadyLocked() const {
    for (int c = 0; c < kClasses; ++c)
      if (!ready_[c].empty()) return true;
    return false;
  }

  // ready_mu_ must be held. Effective class of a queue head = its class
  // minus one per aging_ms_ waited, FLOORED at class 0: promoted work can
  // tie the high class but never outrank it — a decode turn's dispatch
  // wait stays bounded by one running task no matter how stale the
  // backlog, while promoted background beats fresh normal work. Ties go
  // to the NATIVE high class first, then to the longest-waiting head
  // (fairness among promoted classes). Per-class queues are FIFO, so the
  // head is each class's oldest — the candidate aging promoted furthest.
  Op* PopBestLocked() {
    const auto now = std::chrono::steady_clock::now();
    const int aging = aging_ms_.load();
    int best = -1;
    long best_eff = 0;
    bool best_promoted = false;
    std::chrono::steady_clock::time_point best_enq;
    for (int c = 0; c < kClasses; ++c) {
      if (ready_[c].empty()) continue;
      Op* head = ready_[c].front();
      long eff = c;
      if (aging > 0) {
        long waited = std::chrono::duration_cast<std::chrono::milliseconds>(
                          now - head->enq)
                          .count();
        eff -= waited / aging;
        if (eff < 0) eff = 0;
      }
      const bool promoted = c != 0;
      const bool better =
          best < 0 || eff < best_eff ||
          (eff == best_eff && !promoted && best_promoted) ||
          (eff == best_eff && promoted == best_promoted &&
           head->enq < best_enq);
      if (better) {
        best = c;
        best_eff = eff;
        best_promoted = promoted;
        best_enq = head->enq;
      }
    }
    if (best < 0) return nullptr;
    Op* op = ready_[best].front();
    ready_[best].pop_front();
    return op;
  }

  void WorkerLoop() {
    for (;;) {
      Op* op;
      {
        std::unique_lock<std::mutex> lk(ready_mu_);
        ready_cv_.wait(lk, [&] { return shutdown_ || AnyReadyLocked(); });
        if (shutdown_ && !AnyReadyLocked()) return;
        op = PopBestLocked();
      }
      op->fn(op->arg);
      Complete(op);
    }
  }

  void Complete(Op* op) {
    std::vector<Op*> unblocked;
    {
      std::unique_lock<std::mutex> lk(vars_mu_);
      for (uint64_t v : op->reads) Release(v, /*is_write=*/false, &unblocked);
      for (uint64_t v : op->writes) Release(v, /*is_write=*/true, &unblocked);
      pending_.fetch_sub(1);
    }
    idle_cv_.notify_all();
    for (Op* u : unblocked) FinishDep(u);
    delete op;
  }

  // vars_mu_ must be held; collects ops whose dep count on v resolves
  void Release(uint64_t v, bool is_write, std::vector<Op*>* unblocked) {
    auto it = vars_.find(v);
    if (it == vars_.end()) return;
    VarState& s = it->second;
    if (is_write) {
      if (debug_ && s.running_writes > 1)
        RecordErrorLocked("write-write hazard: var " + std::to_string(v) +
                          " had " + std::to_string(s.running_writes) +
                          " concurrent writers at release");
      if (debug_ && s.running_writes > 0 && s.running_reads > 0)
        RecordErrorLocked("read-write hazard: var " + std::to_string(v) +
                          " released a write while " +
                          std::to_string(s.running_reads) +
                          " reader(s) were running");
      --s.running_writes;
    } else {
      --s.running_reads;
    }
    if (debug_ && (s.running_writes < 0 || s.running_reads < 0))
      RecordErrorLocked("release underflow on var " + std::to_string(v));
    // drain: a write runs alone; consecutive reads run together
    while (!s.queue.empty()) {
      auto [op, w] = s.queue.front();
      if (w) {
        if (s.running_reads == 0 && s.running_writes == 0) {
          ++s.running_writes;
          s.queue.pop_front();
          unblocked->push_back(op);
        }
        break;
      }
      if (s.running_writes > 0) break;
      ++s.running_reads;
      s.queue.pop_front();
      unblocked->push_back(op);
    }
  }

  void RecordError(const std::string& msg) {
    std::unique_lock<std::mutex> lk(err_mu_);
    if (last_error_.size() > 4096) return;  // bounded: keep earliest
    if (!last_error_.empty()) last_error_ += "; ";
    last_error_ += msg;
  }
  // alias: callable with vars_mu_ held (err_mu_ is a distinct leaf lock)
  void RecordErrorLocked(const std::string& msg) { RecordError(msg); }

  const int workers_;
  std::vector<std::thread> threads_;
  bool debug_ = false;

  std::mutex vars_mu_;
  std::unordered_map<uint64_t, VarState> vars_;
  uint64_t next_var_ = 1;
  uint64_t next_seq_ = 1;
  std::atomic<int> pending_{0};
  std::condition_variable idle_cv_;  // waits on vars_mu_

  std::mutex err_mu_;
  std::string last_error_;

  std::atomic<int> aging_ms_{100};

  std::mutex ready_mu_;
  std::condition_variable ready_cv_;
  std::deque<Op*> ready_[kClasses];
  bool shutdown_ = false;
};

}  // namespace

extern "C" {

void* MXTPUEngineCreate(int workers) { return new Engine(workers); }
void MXTPUEngineDelete(void* h) { delete static_cast<Engine*>(h); }
uint64_t MXTPUEngineNewVar(void* h) {
  return static_cast<Engine*>(h)->NewVar();
}
void MXTPUEngineDelVar(void* h, uint64_t v) {
  static_cast<Engine*>(h)->DelVar(v);
}
void MXTPUEnginePush(void* h, void (*fn)(void*), void* arg,
                     const uint64_t* reads, int nreads, const uint64_t* writes,
                     int nwrites) {
  static_cast<Engine*>(h)->Push(fn, arg, reads, nreads, writes, nwrites);
}
void MXTPUEnginePushPri(void* h, void (*fn)(void*), void* arg,
                        const uint64_t* reads, int nreads,
                        const uint64_t* writes, int nwrites, int pri) {
  static_cast<Engine*>(h)->Push(fn, arg, reads, nreads, writes, nwrites, pri);
}
void MXTPUEngineSetAgingMs(void* h, int ms) {
  static_cast<Engine*>(h)->SetAgingMs(ms);
}
int MXTPUEngineGetAgingMs(void* h) {
  return static_cast<Engine*>(h)->aging_ms();
}
void MXTPUEngineWaitForVar(void* h, uint64_t v) {
  static_cast<Engine*>(h)->WaitForVar(v);
}
void MXTPUEngineWaitAll(void* h) { static_cast<Engine*>(h)->WaitAll(); }
int MXTPUEngineWaitAllFor(void* h, int timeout_ms) {
  return static_cast<Engine*>(h)->WaitAllFor(timeout_ms);
}
int MXTPUEngineNumWorkers(void* h) {
  return static_cast<Engine*>(h)->workers();
}

// ---- debug / race-detector API ----
void MXTPUEngineSetDebug(void* h, int on) {
  static_cast<Engine*>(h)->SetDebug(on != 0);
}
int MXTPUEngineDebugEnabled(void* h) {
  return static_cast<Engine*>(h)->debug() ? 1 : 0;
}
int MXTPUEngineDebugCheck(void* h) {
  return static_cast<Engine*>(h)->DebugCheck();
}
const char* MXTPUEngineLastError(void* h) {
  return static_cast<Engine*>(h)->LastError();
}
void MXTPUEngineClearError(void* h) {
  static_cast<Engine*>(h)->ClearError();
}
void MXTPUEngineDebugBypassPush(void* h, void (*fn)(void*), void* arg,
                                const uint64_t* reads, int nreads,
                                const uint64_t* writes, int nwrites) {
  static_cast<Engine*>(h)->DebugBypassPush(fn, arg, reads, nreads, writes,
                                           nwrites);
}

}  // extern "C"
