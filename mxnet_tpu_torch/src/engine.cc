// Native host-side dependency engine.
//
// Capability parity: reference src/engine/ (ThreadedEnginePerDevice /
// ThreadedEnginePooled). On the card the *device* scheduling role is played
// by CUDA streams and events; this engine schedules the host side
// (IO, decode, staging, KVStore host reductions) with the reference's
// exact dependency discipline:
//   - variables carry a queue of pending operations
//   - an op lists const (read) vars and mutable (write) vars
//   - reads run concurrently; writes serialize against reads and writes
//   - ops fire when their wait-count drains to zero (OprBlock::wait)
// C ABI (ctypes-friendly):
//   engine_create(num_workers) -> handle
//   engine_new_var(h) -> var id
//   engine_push(h, fn, ctx, const_vars, n_const, mut_vars, n_mut)
//   engine_wait_for_var(h, var)
//   engine_wait_all(h)
//   engine_destroy(h)
// The callback runs on a worker thread; for Python callers the binding
// acquires the GIL inside the trampoline (ctypes does this automatically).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {
typedef void (*engine_fn)(void* ctx);
}

namespace mxtpu {

struct OprBlock;

// A dependency variable: pending-op queue + read/write state
// (reference ThreadedVar, threaded_engine.h:93-195).
struct Var {
  std::mutex mu;
  // queue entries: (is_write, opr)
  std::deque<std::pair<bool, OprBlock*>> queue;
  bool pending_write = false;
  int num_pending_reads = 0;
};

struct OprBlock {
  engine_fn fn;
  void* ctx;
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
  std::atomic<int> wait{0};
};

class ThreadedEngine {
 public:
  explicit ThreadedEngine(int num_workers) : shutdown_(false), inflight_(0) {
    if (num_workers <= 0) num_workers = 4;
    for (int i = 0; i < num_workers; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~ThreadedEngine() {
    WaitAll();
    {
      std::unique_lock<std::mutex> lk(task_mu_);
      shutdown_ = true;
    }
    task_cv_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto& kv : vars_) delete kv.second;
  }

  int64_t NewVar() {
    std::unique_lock<std::mutex> lk(vars_mu_);
    int64_t id = next_var_++;
    vars_[id] = new Var();
    return id;
  }

  Var* GetVar(int64_t id) {
    std::unique_lock<std::mutex> lk(vars_mu_);
    auto it = vars_.find(id);
    return it == vars_.end() ? nullptr : it->second;
  }

  // Parity: Engine::PushAsync (engine.h:147) + Append{Read,Write}Dependency.
  void Push(engine_fn fn, void* ctx, const int64_t* cvars, int n_const,
            const int64_t* mvars, int n_mut) {
    auto* opr = new OprBlock();
    opr->fn = fn;
    opr->ctx = ctx;
    for (int i = 0; i < n_const; ++i) opr->const_vars.push_back(GetVar(cvars[i]));
    for (int i = 0; i < n_mut; ++i) opr->mutable_vars.push_back(GetVar(mvars[i]));
    inflight_.fetch_add(1);

    int pending = 0;
    for (Var* v : opr->const_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (v->pending_write || !v->queue.empty()) {
        v->queue.emplace_back(false, opr);
        ++pending;
      } else {
        ++v->num_pending_reads;
      }
    }
    for (Var* v : opr->mutable_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (v->pending_write || v->num_pending_reads > 0 || !v->queue.empty()) {
        v->queue.emplace_back(true, opr);
        ++pending;
      } else {
        v->pending_write = true;
      }
    }
    // Set wait AFTER appending: fetch_add returns previous; if all deps were
    // already satisfied at append time, the op is ready now.
    int prev = opr->wait.fetch_add(pending);
    if (prev + pending == 0) Enqueue(opr);
  }

  void WaitForVar(int64_t var_id) {
    std::mutex done_mu;
    std::condition_variable done_cv;
    bool done = false;
    struct Ctx {
      std::mutex* mu;
      std::condition_variable* cv;
      bool* done;
    } c{&done_mu, &done_cv, &done};
    auto notify = [](void* p) {
      auto* c = static_cast<Ctx*>(p);
      std::unique_lock<std::mutex> lk(*c->mu);
      *c->done = true;
      c->cv->notify_all();
    };
    int64_t v = var_id;
    Push(notify, &c, &v, 1, nullptr, 0);
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(idle_mu_);
    idle_cv_.wait(lk, [this] { return inflight_.load() == 0; });
  }

 private:
  void Enqueue(OprBlock* opr) {
    {
      std::unique_lock<std::mutex> lk(task_mu_);
      tasks_.push(opr);
    }
    task_cv_.notify_one();
  }

  void WorkerLoop() {
    for (;;) {
      OprBlock* opr = nullptr;
      {
        std::unique_lock<std::mutex> lk(task_mu_);
        task_cv_.wait(lk, [this] { return shutdown_ || !tasks_.empty(); });
        if (shutdown_ && tasks_.empty()) return;
        opr = tasks_.front();
        tasks_.pop();
      }
      opr->fn(opr->ctx);
      OnComplete(opr);
    }
  }

  // Parity: ThreadedEngine::OnComplete (threaded_engine.cc:351) —
  // CompleteReadDependency / CompleteWriteDependency + successor triggering.
  void OnComplete(OprBlock* opr) {
    std::vector<OprBlock*> ready;
    for (Var* v : opr->const_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (--v->num_pending_reads == 0) Drain(v, &ready);
    }
    for (Var* v : opr->mutable_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      v->pending_write = false;
      Drain(v, &ready);
    }
    for (OprBlock* nxt : ready) {
      if (nxt->wait.fetch_sub(1) == 1) Enqueue(nxt);
    }
    delete opr;
    if (inflight_.fetch_sub(1) == 1) {
      std::unique_lock<std::mutex> lk(idle_mu_);
      idle_cv_.notify_all();
    }
  }

  // caller holds v->mu
  void Drain(Var* v, std::vector<OprBlock*>* ready) {
    while (!v->queue.empty()) {
      auto [is_write, opr] = v->queue.front();
      if (is_write) {
        if (v->pending_write || v->num_pending_reads > 0) break;
        v->queue.pop_front();
        v->pending_write = true;
        ready->push_back(opr);
        break;
      } else {
        if (v->pending_write) break;
        v->queue.pop_front();
        ++v->num_pending_reads;
        ready->push_back(opr);
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex task_mu_;
  std::condition_variable task_cv_;
  std::queue<OprBlock*> tasks_;
  bool shutdown_;

  std::mutex vars_mu_;
  std::unordered_map<int64_t, Var*> vars_;
  int64_t next_var_ = 1;

  std::atomic<int> inflight_;
  std::mutex idle_mu_;
  std::condition_variable idle_cv_;
};

}  // namespace mxtpu

extern "C" {

void* engine_create(int num_workers) {
  return new mxtpu::ThreadedEngine(num_workers);
}

void engine_destroy(void* h) { delete static_cast<mxtpu::ThreadedEngine*>(h); }

int64_t engine_new_var(void* h) {
  return static_cast<mxtpu::ThreadedEngine*>(h)->NewVar();
}

void engine_push(void* h, engine_fn fn, void* ctx, const int64_t* cvars,
                 int n_const, const int64_t* mvars, int n_mut) {
  static_cast<mxtpu::ThreadedEngine*>(h)->Push(fn, ctx, cvars, n_const, mvars,
                                               n_mut);
}

void engine_wait_for_var(void* h, int64_t var_id) {
  static_cast<mxtpu::ThreadedEngine*>(h)->WaitForVar(var_id);
}

void engine_wait_all(void* h) {
  static_cast<mxtpu::ThreadedEngine*>(h)->WaitAll();
}

}  // extern "C"
