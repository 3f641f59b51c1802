// pskv: sharded KV parameter server for the parameter-server training mode.
//
// Replacement for the reference's listen_and_serv_op + gRPC stack
// (reference: paddle/fluid/operators/distributed_ops/listen_and_serv_op.cc,
// operators/distributed/ rpc_client.h/grpc_server.cc, ~8.8k LoC) and the
// pslib sparse KV tables (framework/fleet/fleet_wrapper.h). One pserver
// process/thread owns a shard of the model's parameters:
//   * dense tables  — whole parameter tensors, optimizer applied on server
//   * sparse tables — int64 row -> embedding vector, lazily materialized,
//     row-wise optimizer state (the distributed-embedding store)
// Sync mode aggregates gradients from all trainers per round before the
// update (the reference's grad-merge in request_handler_impl.cc); async
// applies each push immediately (Hogwild-style, communicator.h analog).
//
// Wire protocol: length-prefixed binary frames over TCP; thread per
// connection. No external deps (the reference's gRPC/BRPC replaced by a
// ~100-line framing layer — the RPC semantics, not the library, are the
// capability).
//
// Exposed to Python through extern "C" (ctypes) — both the server (runs in
// a background thread, so tests run loopback in one process) and the
// client calls.
//
// paddle_tpu_torch's copy of the JAX package's server (native/pskv/pskv.cc):
// the same wire protocol, byte for byte, so a client of either package
// talks to a server of the other. Built with g++ at first use into
// paddle_tpu_torch/ops/_build/ (distributed/pskv.py).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <fstream>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// protocol
// ---------------------------------------------------------------------------

enum Cmd : uint8_t {
  kCreateDense = 1,
  kInitDense = 2,
  kPullDense = 3,
  kPushDense = 4,
  kCreateSparse = 5,
  kPullSparse = 6,
  kPushSparse = 7,
  kBarrier = 8,
  kShutdown = 9,
  kSetLr = 10,
  kInitSparse = 11,
  kSave = 12,
  kLoad = 13,
};

enum Opt : uint8_t { kOptSgd = 0, kOptAdagrad = 1, kOptAdam = 2 };

enum Status : uint8_t { kOk = 0, kErr = 1 };

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Frame {
  uint8_t cmd = 0;
  std::string name;
  std::vector<char> payload;
};

bool read_frame(int fd, Frame* f) {
  uint32_t total = 0;
  if (!read_full(fd, &total, 4)) return false;
  if (total < 5 || total > (1u << 30)) return false;
  std::vector<char> buf(total);
  if (!read_full(fd, buf.data(), total)) return false;
  f->cmd = static_cast<uint8_t>(buf[0]);
  uint32_t nl;
  std::memcpy(&nl, buf.data() + 1, 4);
  // 64-bit arithmetic: 5 + nl must not wrap (a hostile nl near UINT32_MAX
  // would pass a 32-bit check and read far out of bounds)
  if (static_cast<uint64_t>(5) + nl > total) return false;
  f->name.assign(buf.data() + 5, nl);
  f->payload.assign(buf.begin() + 5 + nl, buf.end());
  return true;
}

bool write_response(int fd, uint8_t status, const void* data, uint32_t len) {
  uint32_t total = 1 + len;
  if (!write_full(fd, &total, 4)) return false;
  if (!write_full(fd, &status, 1)) return false;
  if (len && !write_full(fd, data, len)) return false;
  return true;
}

// ---------------------------------------------------------------------------
// optimizers (server-side, matching the Python op semantics in
// ops/optimizer_ops.py so PS training reproduces local training)
// ---------------------------------------------------------------------------

struct OptConfig {
  uint8_t type = kOptSgd;
  float lr = 0.01f;
  float h0 = 0.9f;    // beta1 / unused
  float h1 = 0.999f;  // beta2 / unused
  float h2 = 1e-8f;   // epsilon
};

// dense optimizer state: flat buffers sized like the param
struct DenseTable {
  std::vector<float> value;
  std::vector<float> m1, m2;  // adagrad: m1; adam: m1+m2
  double beta1_pow = 1.0, beta2_pow = 1.0;
  OptConfig opt;
  // sync aggregation
  std::vector<float> accum;
  uint32_t count = 0;
  uint64_t round_id = 0;
  std::mutex mu;
  std::condition_variable cv;
};

struct SparseRow {
  std::vector<float> value;
  std::vector<float> m1, m2;
};

struct SparseTable {
  uint64_t dim = 0;
  OptConfig opt;
  double beta1_pow = 1.0, beta2_pow = 1.0;
  uint64_t seed = 0;
  float init_scale = 0.0f;  // uniform(-s, s); 0 => zeros
  std::unordered_map<int64_t, SparseRow> rows;
  // sync aggregation
  std::unordered_map<int64_t, std::vector<float>> accum;
  uint32_t count = 0;
  uint64_t round_id = 0;
  std::mutex mu;
  std::condition_variable cv;
};

void apply_dense(DenseTable* t, const float* grad, float scale) {
  const size_t n = t->value.size();
  OptConfig& o = t->opt;
  switch (o.type) {
    case kOptSgd:
      for (size_t i = 0; i < n; ++i) t->value[i] -= o.lr * grad[i] * scale;
      break;
    case kOptAdagrad:
      if (t->m1.empty()) t->m1.assign(n, 0.f);
      for (size_t i = 0; i < n; ++i) {
        float g = grad[i] * scale;
        t->m1[i] += g * g;
        t->value[i] -= o.lr * g / (std::sqrt(t->m1[i]) + o.h2);
      }
      break;
    case kOptAdam: {
      if (t->m1.empty()) {
        t->m1.assign(n, 0.f);
        t->m2.assign(n, 0.f);
      }
      t->beta1_pow *= o.h0;
      t->beta2_pow *= o.h1;
      float lr_t = o.lr * std::sqrt(1.0 - t->beta2_pow) /
                   static_cast<float>(1.0 - t->beta1_pow);
      for (size_t i = 0; i < n; ++i) {
        float g = grad[i] * scale;
        t->m1[i] = o.h0 * t->m1[i] + (1 - o.h0) * g;
        t->m2[i] = o.h1 * t->m2[i] + (1 - o.h1) * g * g;
        t->value[i] -= lr_t * t->m1[i] / (std::sqrt(t->m2[i]) + o.h2);
      }
      break;
    }
  }
}

// one sparse row step; adam's bias correction uses the table-level powers
// advanced once per round (lazy sparse adam, like the device kernel)
void apply_sparse_row(SparseTable* t, SparseRow* r, const float* grad,
                      float scale, float lr_t) {
  const size_t n = t->dim;
  OptConfig& o = t->opt;
  switch (o.type) {
    case kOptSgd:
      for (size_t i = 0; i < n; ++i) r->value[i] -= o.lr * grad[i] * scale;
      break;
    case kOptAdagrad:
      if (r->m1.empty()) r->m1.assign(n, 0.f);
      for (size_t i = 0; i < n; ++i) {
        float g = grad[i] * scale;
        r->m1[i] += g * g;
        r->value[i] -= o.lr * g / (std::sqrt(r->m1[i]) + o.h2);
      }
      break;
    case kOptAdam:
      if (r->m1.empty()) {
        r->m1.assign(n, 0.f);
        r->m2.assign(n, 0.f);
      }
      for (size_t i = 0; i < n; ++i) {
        float g = grad[i] * scale;
        r->m1[i] = o.h0 * r->m1[i] + (1 - o.h0) * g;
        r->m2[i] = o.h1 * r->m2[i] + (1 - o.h1) * g * g;
        r->value[i] -= lr_t * r->m1[i] / (std::sqrt(r->m2[i]) + o.h2);
      }
      break;
  }
}

// xorshift init so sparse rows are deterministic given (seed, id)
void init_row(SparseRow* r, uint64_t dim, uint64_t seed, int64_t id,
              float scale) {
  r->value.assign(dim, 0.f);
  if (scale <= 0.f) return;
  uint64_t s = seed * 2654435761u + static_cast<uint64_t>(id) + 1;
  for (uint64_t i = 0; i < dim; ++i) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    double u = static_cast<double>(s % 1000003) / 1000003.0;  // [0,1)
    r->value[i] = static_cast<float>((2.0 * u - 1.0) * scale);
  }
}

// ---------------------------------------------------------------------------
// server
// ---------------------------------------------------------------------------

struct Server {
  int listen_fd = -1;
  uint32_t trainers = 1;
  bool sync = true;
  // sync aggregation timeout: a crashed trainer must not hang the other
  // trainers' pushes forever (failure detection; 0 = wait indefinitely)
  int64_t sync_timeout_ms = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::mutex conn_mu;
  std::vector<int> conn_fds;  // so stop() can unblock handlers in read()
  std::mutex tables_mu;
  std::map<std::string, std::unique_ptr<DenseTable>> dense;
  std::map<std::string, std::unique_ptr<SparseTable>> sparse;
  // global barrier
  std::mutex bar_mu;
  std::condition_variable bar_cv;
  uint32_t bar_count = 0;
  uint64_t bar_round = 0;
  int port = 0;
};

OptConfig parse_opt(const char* p) {
  OptConfig o;
  o.type = static_cast<uint8_t>(p[0]);
  std::memcpy(&o.lr, p + 1, 4);
  std::memcpy(&o.h0, p + 5, 4);
  std::memcpy(&o.h1, p + 9, 4);
  std::memcpy(&o.h2, p + 13, 4);
  return o;
}

void handle_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  Frame f;
  // `need`: reject frames whose payload is smaller than the handler will
  // read (truncated/hostile frames must not read OOB)
  auto need = [&](size_t n) {
    if (f.payload.size() >= n) return true;
    write_response(fd, kErr, nullptr, 0);
    return false;
  };
  while (!srv->stop.load() && read_frame(fd, &f)) {
    switch (f.cmd) {
      case kCreateDense: {
        // payload: u64 size, opt(17B)
        if (!need(25)) continue;
        uint64_t size;
        std::memcpy(&size, f.payload.data(), 8);
        // bound client-supplied size: value+accum must stay under the 1GiB
        // frame ceiling a trainer could ever init/pull anyway (bad_alloc in
        // a handler thread would std::terminate the server)
        if (size == 0 || size > (1u << 28)) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        OptConfig o = parse_opt(f.payload.data() + 8);
        bool ok = true;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->dense.find(f.name);
          if (it == srv->dense.end()) {
            auto t = std::make_unique<DenseTable>();
            t->value.assign(size, 0.f);
            t->accum.assign(size, 0.f);
            t->opt = o;
            srv->dense[f.name] = std::move(t);
          } else if (it->second->value.size() != size) {
            // a trainer rebuilt its model against a live server with a
            // different shape — silently reusing the old table would train
            // on garbage; surface the mismatch instead
            ok = false;
          }
        }
        write_response(fd, ok ? kOk : kErr, nullptr, 0);
        break;
      }
      case kInitDense: {
        DenseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->dense.find(f.name);
          if (it == srv->dense.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        std::lock_guard<std::mutex> l(t->mu);
        size_t n = f.payload.size() / 4;
        if (n != t->value.size()) {
          // size-mismatched init must not reply kOk: the trainer would
          // proceed to train against zero-initialized params
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        std::memcpy(t->value.data(), f.payload.data(), f.payload.size());
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kPullDense: {
        DenseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->dense.find(f.name);
          if (it == srv->dense.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        std::lock_guard<std::mutex> l(t->mu);
        write_response(fd, kOk, t->value.data(),
                       static_cast<uint32_t>(t->value.size() * 4));
        break;
      }
      case kPushDense: {
        // payload: u32 trainer_id, f32 grad[size]
        if (!need(4)) continue;
        DenseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->dense.find(f.name);
          if (it == srv->dense.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        const float* grad =
            reinterpret_cast<const float*>(f.payload.data() + 4);
        size_t n = (f.payload.size() - 4) / 4;
        std::unique_lock<std::mutex> l(t->mu);
        if (n != t->value.size()) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        if (!srv->sync) {
          apply_dense(t, grad, 1.0f);
        } else {
          for (size_t i = 0; i < n; ++i) t->accum[i] += grad[i];
          t->count++;
          uint64_t my_round = t->round_id;
          bool timed_out = false;
          if (t->count == srv->trainers) {
            // mean of trainer grads -> same trajectory as local training
            apply_dense(t, t->accum.data(), 1.0f / srv->trainers);
            std::fill(t->accum.begin(), t->accum.end(), 0.f);
            t->count = 0;
            t->round_id++;
            t->cv.notify_all();
          } else if (srv->sync_timeout_ms > 0) {
            timed_out = !t->cv.wait_for(
                l, std::chrono::milliseconds(srv->sync_timeout_ms), [&] {
                  return t->round_id != my_round || srv->stop.load();
                });
          } else {
            t->cv.wait(l, [&] {
              return t->round_id != my_round || srv->stop.load();
            });
          }
          if (timed_out) {
            // undo this trainer's contribution so a retry can't double it
            for (size_t i = 0; i < n; ++i) t->accum[i] -= grad[i];
            t->count--;
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kCreateSparse: {
        // payload: u64 dim, opt(17B), f32 init_scale, u64 seed
        if (!need(37)) continue;
        uint64_t dim;
        std::memcpy(&dim, f.payload.data(), 8);
        // bound dim so all later n*dim*4 arithmetic fits in 64 bits with
        // room to spare (payloads are <=1GiB, so a larger dim could never
        // carry even one row anyway)
        if (dim == 0 || dim > (1u << 28)) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        OptConfig o = parse_opt(f.payload.data() + 8);
        float init_scale;
        std::memcpy(&init_scale, f.payload.data() + 25, 4);
        uint64_t seed;
        std::memcpy(&seed, f.payload.data() + 29, 8);
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          if (!srv->sparse.count(f.name)) {
            auto t = std::make_unique<SparseTable>();
            t->dim = dim;
            t->opt = o;
            t->init_scale = init_scale;
            t->seed = seed;
            srv->sparse[f.name] = std::move(t);
          }
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kPullSparse: {
        // payload: u64 n, i64 ids[n] -> f32 out[n*dim]
        SparseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->sparse.find(f.name);
          if (it == srv->sparse.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        if (!need(8)) continue;
        uint64_t n;
        std::memcpy(&n, f.payload.data(), 8);
        // bound n BEFORE any size arithmetic: for n >= 2^61 the u64
        // multiply in 8 + n*8 wraps, a naive need(8 + n*8) check passes,
        // and ids would be read far out of bounds. n <= (payload-8)/8
        // implies 8 + n*8 <= payload with no overflow possible.
        if (n > (f.payload.size() - 8) / 8) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        // response length is a u32 on the wire; dim<=2^28 and n<=2^27 keep
        // n*dim*4 well-defined, but it can still exceed 4GiB-1
        if (n * t->dim * 4 > 0xFFFFFFFFull) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        const int64_t* ids =
            reinterpret_cast<const int64_t*>(f.payload.data() + 8);
        std::vector<float> out(n * t->dim);
        {
          std::lock_guard<std::mutex> l(t->mu);
          for (uint64_t i = 0; i < n; ++i) {
            auto& row = t->rows[ids[i]];
            if (row.value.empty())
              init_row(&row, t->dim, t->seed, ids[i], t->init_scale);
            std::memcpy(out.data() + i * t->dim, row.value.data(),
                        t->dim * 4);
          }
        }
        write_response(fd, kOk, out.data(),
                       static_cast<uint32_t>(out.size() * 4));
        break;
      }
      case kPushSparse: {
        // payload: u32 trainer_id, u64 n, i64 ids[n], f32 grads[n*dim]
        SparseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->sparse.find(f.name);
          if (it == srv->sparse.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        if (!need(12)) continue;
        uint64_t n;
        std::memcpy(&n, f.payload.data() + 4, 8);
        // same overflow-safe bounding as kPullSparse: first cap n by the
        // ids region alone (no multiplication can wrap under that cap,
        // since payload <= 1GiB and dim <= 2^28), then check the full size
        if (n > (f.payload.size() - 12) / 8) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        if (!need(12 + n * 8 + n * t->dim * 4)) continue;
        const int64_t* ids =
            reinterpret_cast<const int64_t*>(f.payload.data() + 12);
        const float* grads =
            reinterpret_cast<const float*>(f.payload.data() + 12 + n * 8);
        std::unique_lock<std::mutex> l(t->mu);
        float lr_t = t->opt.lr;
        if (!srv->sync) {
          if (t->opt.type == kOptAdam) {
            t->beta1_pow *= t->opt.h0;
            t->beta2_pow *= t->opt.h1;
            lr_t = t->opt.lr * std::sqrt(1.0 - t->beta2_pow) /
                   static_cast<float>(1.0 - t->beta1_pow);
          }
          // merge duplicate ids within the push before row updates
          std::unordered_map<int64_t, std::vector<float>> merged;
          for (uint64_t i = 0; i < n; ++i) {
            auto& g = merged[ids[i]];
            if (g.empty()) g.assign(t->dim, 0.f);
            for (uint64_t d = 0; d < t->dim; ++d)
              g[d] += grads[i * t->dim + d];
          }
          for (auto& kv : merged) {
            auto& row = t->rows[kv.first];
            if (row.value.empty())
              init_row(&row, t->dim, t->seed, kv.first, t->init_scale);
            apply_sparse_row(t, &row, kv.second.data(), 1.0f, lr_t);
          }
        } else {
          // ids whose accum entry THIS push creates — exact rollback set
          std::vector<int64_t> inserted;
          for (uint64_t i = 0; i < n; ++i) {
            auto emplaced = t->accum.try_emplace(ids[i]);
            auto& g = emplaced.first->second;
            if (emplaced.second) {
              g.assign(t->dim, 0.f);
              inserted.push_back(ids[i]);
            }
            for (uint64_t d = 0; d < t->dim; ++d)
              g[d] += grads[i * t->dim + d];
          }
          t->count++;
          uint64_t my_round = t->round_id;
          bool timed_out = false;
          if (t->count == srv->trainers) {
            if (t->opt.type == kOptAdam) {
              t->beta1_pow *= t->opt.h0;
              t->beta2_pow *= t->opt.h1;
              lr_t = t->opt.lr * std::sqrt(1.0 - t->beta2_pow) /
                     static_cast<float>(1.0 - t->beta1_pow);
            }
            for (auto& kv : t->accum) {
              auto& row = t->rows[kv.first];
              if (row.value.empty())
                init_row(&row, t->dim, t->seed, kv.first, t->init_scale);
              apply_sparse_row(t, &row, kv.second.data(),
                               1.0f / srv->trainers, lr_t);
            }
            t->accum.clear();
            t->count = 0;
            t->round_id++;
            t->cv.notify_all();
          } else if (srv->sync_timeout_ms > 0) {
            timed_out = !t->cv.wait_for(
                l, std::chrono::milliseconds(srv->sync_timeout_ms), [&] {
                  return t->round_id != my_round || srv->stop.load();
                });
          } else {
            t->cv.wait(l, [&] {
              return t->round_id != my_round || srv->stop.load();
            });
          }
          if (timed_out) {
            for (uint64_t i = 0; i < n; ++i) {
              auto it2 = t->accum.find(ids[i]);
              if (it2 == t->accum.end()) continue;
              for (uint64_t d = 0; d < t->dim; ++d)
                it2->second[d] -= grads[i * t->dim + d];
            }
            // erase exactly the entries this push created (another
            // trainer's legitimately-zero entry must survive)
            for (int64_t id : inserted) {
              auto it2 = t->accum.find(id);
              if (it2 != t->accum.end()) {
                bool mine_only = true;
                for (uint64_t d = 0; d < t->dim && mine_only; ++d)
                  mine_only = it2->second[d] == 0.0f;
                if (mine_only) t->accum.erase(it2);
              }
            }
            t->count--;
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kInitSparse: {
        // payload: u64 n, i64 ids[n], f32 values[n*dim] — direct row set so
        // trainer 0 can seed the table from its initializer (the reference
        // inits pserver tables from the trainer startup program)
        SparseTable* t;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          auto it = srv->sparse.find(f.name);
          if (it == srv->sparse.end()) {
            write_response(fd, kErr, nullptr, 0);
            continue;
          }
          t = it->second.get();
        }
        if (!need(8)) continue;
        uint64_t n;
        std::memcpy(&n, f.payload.data(), 8);
        if (!need(8 + n * 8 + n * t->dim * 4)) continue;
        const int64_t* ids =
            reinterpret_cast<const int64_t*>(f.payload.data() + 8);
        const float* vals =
            reinterpret_cast<const float*>(f.payload.data() + 8 + n * 8);
        std::lock_guard<std::mutex> l(t->mu);
        for (uint64_t i = 0; i < n; ++i) {
          auto& row = t->rows[ids[i]];
          row.value.assign(vals + i * t->dim, vals + (i + 1) * t->dim);
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kSave: {
        // payload = path; serialize every table incl. optimizer state
        // (reference: RequestCheckpoint in request_handler_impl.cc — the
        // pserver snapshots its shard on a trainer's checkpoint_notify)
        std::string path(f.payload.begin(), f.payload.end());
        std::ofstream out(path, std::ios::binary);
        if (!out) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        // snapshot the table lists under the global lock, then serialize
        // each table under ITS OWN lock — a long checkpoint must not
        // stall every other request behind tables_mu
        std::vector<std::pair<std::string, DenseTable*>> dense_list;
        std::vector<std::pair<std::string, SparseTable*>> sparse_list;
        {
          std::lock_guard<std::mutex> l(srv->tables_mu);
          for (auto& kv : srv->dense)
            dense_list.emplace_back(kv.first, kv.second.get());
          for (auto& kv : srv->sparse)
            sparse_list.emplace_back(kv.first, kv.second.get());
        }
        // copy-on-save: serialize each table to a memory buffer under its
        // lock, stream buffers to disk with NO lock held — trainer pushes
        // stall only for the memcpy, not the disk write
        std::string buf;
        auto wr = [&](const void* p, size_t n) {
          buf.append(static_cast<const char*>(p), n);
        };
        auto wr_str = [&](const std::string& s2) {
          uint32_t n = s2.size();
          wr(&n, 4);
          wr(s2.data(), n);
        };
        auto wr_vec = [&](const std::vector<float>& v) {
          uint64_t n = v.size();
          wr(&n, 8);
          wr(v.data(), n * 4);
        };
        auto flush_buf = [&]() {
          out.write(buf.data(), buf.size());
          buf.clear();
        };
        uint32_t nd = dense_list.size();
        wr(&nd, 4);
        for (auto& kv : dense_list) {
          DenseTable* t = kv.second;
          {
            std::lock_guard<std::mutex> tl(t->mu);
            wr_str(kv.first);
            wr(&t->opt, sizeof(OptConfig));
            wr(&t->beta1_pow, 8);
            wr(&t->beta2_pow, 8);
            wr_vec(t->value);
            wr_vec(t->m1);
            wr_vec(t->m2);
          }
          flush_buf();
        }
        uint32_t ns = sparse_list.size();
        wr(&ns, 4);
        for (auto& kv : sparse_list) {
          SparseTable* t = kv.second;
          {
            std::lock_guard<std::mutex> tl(t->mu);
            wr_str(kv.first);
            wr(&t->dim, 8);
            wr(&t->opt, sizeof(OptConfig));
            wr(&t->beta1_pow, 8);
            wr(&t->beta2_pow, 8);
            wr(&t->seed, 8);
            wr(&t->init_scale, 4);
            uint64_t nr = t->rows.size();
            wr(&nr, 8);
            for (auto& rkv : t->rows) {
              int64_t id = rkv.first;
              wr(&id, 8);
              wr_vec(rkv.second.value);
              wr_vec(rkv.second.m1);
              wr_vec(rkv.second.m2);
            }
          }
          flush_buf();
        }
        flush_buf();  // table counts when a section is empty
        out.flush();  // surface ENOSPC-at-flush before answering
        write_response(fd, out.good() ? kOk : kErr, nullptr, 0);
        break;
      }
      case kLoad: {
        std::string path(f.payload.begin(), f.payload.end());
        std::ifstream in(path, std::ios::binary);
        if (!in) {
          write_response(fd, kErr, nullptr, 0);
          continue;
        }
        // STAGE the whole file first, COMMIT only if every read
        // validated — a truncated/corrupt checkpoint must leave the
        // live tables completely untouched; commits update tables in
        // place under their own mutexes so handlers holding pointers
        // never see a free
        bool ok = true;
        auto rd = [&](void* p, size_t n) {
          if (!ok) return false;
          in.read(static_cast<char*>(p), n);
          ok = static_cast<size_t>(in.gcount()) == n;
          return ok;
        };
        auto rd_str = [&](std::string* s2) {
          uint32_t n = 0;
          if (!rd(&n, 4) || n > (1u << 20)) { ok = false; return; }
          s2->resize(n);
          rd(&(*s2)[0], n);
        };
        auto rd_vec = [&](std::vector<float>* v) {
          uint64_t n = 0;
          if (!rd(&n, 8) || n > (1ull << 31)) { ok = false; return; }
          v->resize(n);
          rd(v->data(), n * 4);
        };
        struct DenseStage {
          std::string name;
          OptConfig opt;
          double b1, b2;
          std::vector<float> value, m1, m2;
        };
        struct SparseStage {
          std::string name;
          uint64_t dim;
          OptConfig opt;
          double b1, b2;
          uint64_t seed;
          float init_scale;
          std::unordered_map<int64_t, SparseRow> rows;
        };
        std::vector<DenseStage> dstage;
        std::vector<SparseStage> sstage;
        uint32_t nd = 0;
        if (!rd(&nd, 4) || nd > (1u << 20)) ok = false;
        for (uint32_t i = 0; ok && i < nd; ++i) {
          DenseStage d;
          rd_str(&d.name);
          rd(&d.opt, sizeof(OptConfig));
          rd(&d.b1, 8);
          rd(&d.b2, 8);
          rd_vec(&d.value);
          rd_vec(&d.m1);
          rd_vec(&d.m2);
          if (ok) dstage.emplace_back(std::move(d));
        }
        uint32_t ns = 0;
        if (ok && (!rd(&ns, 4) || ns > (1u << 20))) ok = false;
        for (uint32_t i = 0; ok && i < ns; ++i) {
          SparseStage sp;
          rd_str(&sp.name);
          rd(&sp.dim, 8);
          rd(&sp.opt, sizeof(OptConfig));
          rd(&sp.b1, 8);
          rd(&sp.b2, 8);
          rd(&sp.seed, 8);
          rd(&sp.init_scale, 4);
          uint64_t nr = 0;
          if (!rd(&nr, 8) || nr > (1ull << 31)) { ok = false; break; }
          for (uint64_t r = 0; ok && r < nr; ++r) {
            int64_t id = 0;
            rd(&id, 8);
            SparseRow row;
            rd_vec(&row.value);
            rd_vec(&row.m1);
            rd_vec(&row.m2);
            if (ok) sp.rows[id] = std::move(row);
          }
          if (ok) sstage.emplace_back(std::move(sp));
        }
        if (!ok) {
          write_response(fd, kErr, nullptr, 0);
          break;
        }
        std::lock_guard<std::mutex> l(srv->tables_mu);
        for (auto& d : dstage) {
          auto it = srv->dense.find(d.name);
          DenseTable* t;
          if (it == srv->dense.end()) {
            auto nt = std::make_unique<DenseTable>();
            t = nt.get();
            srv->dense[d.name] = std::move(nt);
          } else {
            t = it->second.get();
          }
          std::lock_guard<std::mutex> tl(t->mu);
          t->opt = d.opt;
          t->beta1_pow = d.b1;
          t->beta2_pow = d.b2;
          t->value = std::move(d.value);
          t->m1 = std::move(d.m1);
          t->m2 = std::move(d.m2);
          t->accum.assign(t->value.size(), 0.f);
        }
        for (auto& sp : sstage) {
          auto it = srv->sparse.find(sp.name);
          SparseTable* t;
          if (it == srv->sparse.end()) {
            auto nt = std::make_unique<SparseTable>();
            t = nt.get();
            srv->sparse[sp.name] = std::move(nt);
          } else {
            t = it->second.get();
          }
          std::lock_guard<std::mutex> tl(t->mu);
          t->dim = sp.dim;
          t->opt = sp.opt;
          t->beta1_pow = sp.b1;
          t->beta2_pow = sp.b2;
          t->seed = sp.seed;
          t->init_scale = sp.init_scale;
          t->rows = std::move(sp.rows);
          t->accum.clear();
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kBarrier: {
        std::unique_lock<std::mutex> l(srv->bar_mu);
        srv->bar_count++;
        uint64_t my_round = srv->bar_round;
        if (srv->bar_count == srv->trainers) {
          srv->bar_count = 0;
          srv->bar_round++;
          srv->bar_cv.notify_all();
        } else {
          srv->bar_cv.wait(l, [&] {
            return srv->bar_round != my_round || srv->stop.load();
          });
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kSetLr: {
        if (!need(4)) continue;
        float lr;
        std::memcpy(&lr, f.payload.data(), 4);
        std::lock_guard<std::mutex> l(srv->tables_mu);
        auto it = srv->dense.find(f.name);
        if (it != srv->dense.end()) {
          std::lock_guard<std::mutex> tl(it->second->mu);
          it->second->opt.lr = lr;
        }
        auto is = srv->sparse.find(f.name);
        if (is != srv->sparse.end()) {
          std::lock_guard<std::mutex> tl(is->second->mu);
          is->second->opt.lr = lr;
        }
        write_response(fd, kOk, nullptr, 0);
        break;
      }
      case kShutdown: {
        srv->stop.store(true);
        // wake sync waiters
        {
          std::lock_guard<std::mutex> l(srv->bar_mu);
          srv->bar_cv.notify_all();
        }
        std::lock_guard<std::mutex> l(srv->tables_mu);
        for (auto& kv : srv->dense) kv.second->cv.notify_all();
        for (auto& kv : srv->sparse) kv.second->cv.notify_all();
        write_response(fd, kOk, nullptr, 0);
        ::shutdown(srv->listen_fd, SHUT_RDWR);
        break;
      }
      default:
        write_response(fd, kErr, nullptr, 0);
    }
  }
  ::close(fd);
}

void accept_loop(Server* srv) {
  while (!srv->stop.load()) {
    int fd = ::accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (srv->stop.load()) break;
      continue;
    }
    {
      std::lock_guard<std::mutex> l(srv->conn_mu);
      srv->conn_fds.push_back(fd);
    }
    srv->conns.emplace_back(handle_conn, srv, fd);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// returns opaque server handle, or 0 on failure; port==0 picks a free port
// (retrieve with pskv_server_port)
void* pskv_server_start(int port, int trainers, int sync,
                        int64_t sync_timeout_ms) {
  auto* srv = new Server();
  srv->trainers = static_cast<uint32_t>(trainers);
  srv->sync = sync != 0;
  srv->sync_timeout_ms = sync_timeout_ms;
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(srv->listen_fd, 64) != 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread(accept_loop, srv);
  return srv;
}

int pskv_server_port(void* handle) {
  return static_cast<Server*>(handle)->port;
}

// 1 once a shutdown command was received (run_pserver polls this)
int pskv_server_stopped(void* handle) {
  return static_cast<Server*>(handle)->stop.load() ? 1 : 0;
}

void pskv_server_stop(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  srv->stop.store(true);
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  {
    std::lock_guard<std::mutex> l(srv->bar_mu);
    srv->bar_cv.notify_all();
  }
  {
    std::lock_guard<std::mutex> l(srv->tables_mu);
    for (auto& kv : srv->dense) kv.second->cv.notify_all();
    for (auto& kv : srv->sparse) kv.second->cv.notify_all();
  }
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  {
    // unblock handlers parked in read() on still-open client sockets —
    // without this, a crashed trainer leaves stop() joining forever
    std::lock_guard<std::mutex> l(srv->conn_mu);
    for (int cfd : srv->conn_fds) ::shutdown(cfd, SHUT_RDWR);
  }
  for (auto& t : srv->conns)
    if (t.joinable()) t.join();
  delete srv;
}

int pskv_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  // retry while the server comes up (launcher races)
  for (int i = 0; i < 100; ++i) {
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    usleep(50 * 1000);
  }
  ::close(fd);
  return -1;
}

void pskv_close(int fd) { ::close(fd); }

namespace {
int send_cmd(int fd, uint8_t cmd, const char* name,
             const std::vector<std::pair<const void*, size_t>>& parts,
             void* resp, size_t resp_len) {
  uint32_t nl = static_cast<uint32_t>(std::strlen(name));
  size_t payload = 0;
  for (auto& p : parts) payload += p.second;
  uint32_t total = 5 + nl + static_cast<uint32_t>(payload);
  if (!write_full(fd, &total, 4)) return -1;
  if (!write_full(fd, &cmd, 1)) return -1;
  if (!write_full(fd, &nl, 4)) return -1;
  if (nl && !write_full(fd, name, nl)) return -1;
  for (auto& p : parts)
    if (p.second && !write_full(fd, p.first, p.second)) return -1;
  uint32_t rtotal;
  if (!read_full(fd, &rtotal, 4)) return -1;
  uint8_t status;
  if (!read_full(fd, &status, 1)) return -1;
  size_t body = rtotal - 1;
  if (body > 0) {
    if (resp && body <= resp_len) {
      if (!read_full(fd, resp, body)) return -1;
    } else {  // drain
      std::vector<char> junk(body);
      if (!read_full(fd, junk.data(), body)) return -1;
    }
  }
  return status == kOk ? 0 : -2;
}

struct OptBytes {
  char b[17];
};
OptBytes pack_opt(int opt_type, float lr, float h0, float h1, float h2) {
  OptBytes o;
  o.b[0] = static_cast<char>(opt_type);
  std::memcpy(o.b + 1, &lr, 4);
  std::memcpy(o.b + 5, &h0, 4);
  std::memcpy(o.b + 9, &h1, 4);
  std::memcpy(o.b + 13, &h2, 4);
  return o;
}
}  // namespace

int pskv_create_dense(int fd, const char* name, uint64_t size, int opt_type,
                      float lr, float h0, float h1, float h2) {
  OptBytes o = pack_opt(opt_type, lr, h0, h1, h2);
  return send_cmd(fd, kCreateDense, name, {{&size, 8}, {o.b, 17}}, nullptr,
                  0);
}

int pskv_init_dense(int fd, const char* name, const float* data,
                    uint64_t size) {
  return send_cmd(fd, kInitDense, name, {{data, size * 4}}, nullptr, 0);
}

int pskv_pull_dense(int fd, const char* name, float* out, uint64_t size) {
  return send_cmd(fd, kPullDense, name, {}, out, size * 4);
}

int pskv_push_dense(int fd, const char* name, uint32_t trainer_id,
                    const float* grad, uint64_t size) {
  return send_cmd(fd, kPushDense, name, {{&trainer_id, 4}, {grad, size * 4}},
                  nullptr, 0);
}

int pskv_create_sparse(int fd, const char* name, uint64_t dim, int opt_type,
                       float lr, float h0, float h1, float h2,
                       float init_scale, uint64_t seed) {
  OptBytes o = pack_opt(opt_type, lr, h0, h1, h2);
  return send_cmd(fd, kCreateSparse, name,
                  {{&dim, 8}, {o.b, 17}, {&init_scale, 4}, {&seed, 8}},
                  nullptr, 0);
}

int pskv_pull_sparse(int fd, const char* name, const int64_t* ids, uint64_t n,
                     float* out, uint64_t dim) {
  return send_cmd(fd, kPullSparse, name, {{&n, 8}, {ids, n * 8}}, out,
                  n * dim * 4);
}

int pskv_push_sparse(int fd, const char* name, uint32_t trainer_id,
                     const int64_t* ids, uint64_t n, const float* grads,
                     uint64_t dim) {
  return send_cmd(fd, kPushSparse, name,
                  {{&trainer_id, 4}, {&n, 8}, {ids, n * 8},
                   {grads, n * dim * 4}},
                  nullptr, 0);
}

int pskv_init_sparse(int fd, const char* name, const int64_t* ids, uint64_t n,
                     const float* vals, uint64_t dim) {
  return send_cmd(fd, kInitSparse, name,
                  {{&n, 8}, {ids, n * 8}, {vals, n * dim * 4}}, nullptr, 0);
}

int pskv_save(int fd, const char* path) {
  return send_cmd(fd, kSave, "", {{path, std::strlen(path)}}, nullptr, 0);
}

int pskv_load(int fd, const char* path) {
  return send_cmd(fd, kLoad, "", {{path, std::strlen(path)}}, nullptr, 0);
}

int pskv_barrier(int fd, uint32_t trainer_id) {
  return send_cmd(fd, kBarrier, "", {{&trainer_id, 4}}, nullptr, 0);
}

int pskv_set_lr(int fd, const char* name, float lr) {
  return send_cmd(fd, kSetLr, name, {{&lr, 4}}, nullptr, 0);
}

int pskv_shutdown(int fd) {
  return send_cmd(fd, kShutdown, "", {}, nullptr, 0);
}

}  // extern "C"
