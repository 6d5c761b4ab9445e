// ds_aio_uring — io_uring-backed async block I/O engine.
//
// TPU-native rebuild of the reference's libaio queue-depth engine
// (csrc/aio/py_lib/deepspeed_aio_thread.cpp + deepspeed_py_io_handle.cpp):
// instead of a pool of threads each doing synchronous pread/pwrite (the
// fallback engine in ds_aio.cpp), ONE driver thread keeps `queue_depth`
// chunk-sized operations in flight inside a single io_uring — the kernel's
// async submission path is what saturates NVMe queue pairs, which is the
// property ZeRO-Infinity swap throughput depends on.
//
// Raw ABI (no liburing in this image): io_uring_setup/enter via syscall(2),
// SQ/CQ rings mmap'd per <linux/io_uring.h>.  O_DIRECT is applied
// per-request when the (buffer, offset, length) triple is 4KiB-aligned —
// misaligned requests silently fall back to page-cache I/O, so callers can
// opt in without alignment bookkeeping (aio_aligned_empty in ops/aio.py
// produces qualifying buffers).
//
// Exposed as a plain C API for ctypes, mirroring ds_aio.cpp's exports with
// a ds_uring_ prefix; ops/aio.py's AIOHandle picks the engine at runtime.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kDirectAlign = 4096;

int io_uring_setup(unsigned entries, io_uring_params* p) {
    return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                   unsigned flags) {
    return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                    min_complete, flags, nullptr, 0));
}

struct Request {
    std::atomic<int64_t> pending_chunks{0};
    std::atomic<int64_t> errors{0};
    int fd = -1;
    std::mutex mu;
    std::condition_variable cv;
};

struct Chunk {
    std::shared_ptr<Request> req;
    char* buf;
    int64_t count;
    int64_t offset;
    bool write;
};

class UringEngine {
  public:
    static bool available() {
        io_uring_params p{};
        int fd = io_uring_setup(2, &p);
        if (fd < 0) return false;
        ::close(fd);
        return true;
    }

    UringEngine(int64_t block_size, int queue_depth, bool o_direct)
        : block_size_(block_size > 0 ? block_size : (1 << 20)),
          queue_depth_(queue_depth > 0 ? queue_depth : 32),
          o_direct_(o_direct) {
        io_uring_params p{};
        ring_fd_ = io_uring_setup(queue_depth_, &p);
        if (ring_fd_ < 0) throw std::runtime_error("io_uring_setup failed");
        sq_entries_ = p.sq_entries;
        cq_entries_ = p.cq_entries;

        size_t sq_sz = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
        size_t cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        if (p.features & IORING_FEAT_SINGLE_MMAP) {
            sq_map_sz_ = cq_map_sz_ = std::max(sq_sz, cq_sz);
            sq_ring_ = mmap_ring(sq_map_sz_, IORING_OFF_SQ_RING);
            cq_ring_ = sq_ring_;
        } else {
            sq_map_sz_ = sq_sz;
            cq_map_sz_ = cq_sz;
            sq_ring_ = mmap_ring(sq_sz, IORING_OFF_SQ_RING);
            cq_ring_ = mmap_ring(cq_sz, IORING_OFF_CQ_RING);
        }
        sqes_sz_ = p.sq_entries * sizeof(io_uring_sqe);
        sqes_ = static_cast<io_uring_sqe*>(
            mmap_ring(sqes_sz_, IORING_OFF_SQES));

        sq_head_ = ring_u32(sq_ring_, p.sq_off.head);
        sq_tail_ = ring_u32(sq_ring_, p.sq_off.tail);
        sq_mask_ = *ring_u32(sq_ring_, p.sq_off.ring_mask);
        sq_array_ = ring_u32(sq_ring_, p.sq_off.array);
        cq_head_ = ring_u32(cq_ring_, p.cq_off.head);
        cq_tail_ = ring_u32(cq_ring_, p.cq_off.tail);
        cq_mask_ = *ring_u32(cq_ring_, p.cq_off.ring_mask);
        cqes_ = reinterpret_cast<io_uring_cqe*>(
            static_cast<char*>(cq_ring_) + p.cq_off.cqes);

        driver_ = std::thread([this] { drive(); });
    }

    ~UringEngine() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        if (driver_.joinable()) driver_.join();
        if (sqes_) munmap(sqes_, sqes_sz_);
        if (cq_ring_ && cq_ring_ != sq_ring_) munmap(cq_ring_, cq_map_sz_);
        if (sq_ring_) munmap(sq_ring_, sq_map_sz_);
        if (ring_fd_ >= 0) ::close(ring_fd_);
    }

    int64_t submit(const char* path, void* buf, int64_t count, int64_t offset,
                   bool write) {
        auto req = std::make_shared<Request>();
        int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
        bool aligned = o_direct_ && count > 0 &&
                       (reinterpret_cast<uintptr_t>(buf) % kDirectAlign) == 0 &&
                       (offset % kDirectAlign) == 0 &&
                       (count % kDirectAlign) == 0;
#ifdef O_DIRECT
        if (aligned) flags |= O_DIRECT;
#endif
        req->fd = ::open(path, flags, 0644);
        int64_t n_chunks =
            count > 0 ? (count + block_size_ - 1) / block_size_ : 1;
        req->pending_chunks.store(n_chunks);
        int64_t id;
        {
            std::lock_guard<std::mutex> lk(mu_);
            id = next_id_++;
            requests_[id] = req;
            if (req->fd < 0) {
                req->errors.fetch_add(1);
                req->pending_chunks.store(0);
            } else {
                for (int64_t c = 0; c < n_chunks; ++c) {
                    int64_t off = c * block_size_;
                    int64_t len = std::min(block_size_, count - off);
                    if (len < 0) len = 0;
                    chunks_.push_back(Chunk{req, static_cast<char*>(buf) + off,
                                            len, offset + off, write});
                }
            }
        }
        cv_.notify_all();
        return id;
    }

    int wait(int64_t id) {
        std::shared_ptr<Request> req;
        {
            std::lock_guard<std::mutex> lk(mu_);
            auto it = requests_.find(id);
            if (it == requests_.end()) return -2;
            req = it->second;
        }
        {
            std::unique_lock<std::mutex> lk(req->mu);
            req->cv.wait(lk, [&] { return req->pending_chunks.load() == 0; });
        }
        int rc = req->errors.load() ? -1 : 0;
        {
            std::lock_guard<std::mutex> lk(mu_);
            requests_.erase(id);
        }
        return rc;
    }

    int64_t pending() {
        std::lock_guard<std::mutex> lk(mu_);
        return static_cast<int64_t>(requests_.size());
    }

    int64_t block_size() const { return block_size_; }
    int queue_depth() const { return queue_depth_; }

  private:
    void* mmap_ring(size_t sz, uint64_t off) {
        void* p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
                       MAP_SHARED | MAP_POPULATE, ring_fd_, off);
        if (p == MAP_FAILED) throw std::runtime_error("io_uring mmap failed");
        return p;
    }

    static uint32_t* ring_u32(void* base, uint32_t off) {
        return reinterpret_cast<uint32_t*>(static_cast<char*>(base) + off);
    }

    // Driver loop: keep up to sq_entries_ chunk ops in flight; block in
    // io_uring_enter(GETEVENTS) only while something is in flight, else on
    // the condition variable.  Short reads/writes are re-queued with the
    // remainder adjusted — required for O_DIRECT tails and EINTR.
    void drive() {
        for (;;) {
            unsigned to_submit = 0;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] {
                    return stop_ || !chunks_.empty() || inflight_ > 0;
                });
                if (stop_ && chunks_.empty() && inflight_ == 0) return;
                // fill SQEs from the chunk queue
                uint32_t tail = load_acquire(sq_tail_);
                while (!chunks_.empty() &&
                       inflight_ + to_submit < static_cast<unsigned>(
                                                   sq_entries_)) {
                    Chunk* c = new Chunk(std::move(chunks_.front()));
                    chunks_.pop_front();
                    if (c->count == 0) {  // zero-length: complete immediately
                        complete_chunk(c, /*err=*/false);
                        continue;
                    }
                    uint32_t idx = tail & sq_mask_;
                    io_uring_sqe* sqe = &sqes_[idx];
                    std::memset(sqe, 0, sizeof(*sqe));
                    sqe->opcode = c->write ? IORING_OP_WRITE : IORING_OP_READ;
                    sqe->fd = c->req->fd;
                    sqe->addr = reinterpret_cast<uint64_t>(c->buf);
                    sqe->len = static_cast<uint32_t>(c->count);
                    sqe->off = static_cast<uint64_t>(c->offset);
                    sqe->user_data = reinterpret_cast<uint64_t>(c);
                    sq_array_[idx] = idx;
                    ++tail;
                    ++to_submit;
                }
                store_release(sq_tail_, tail);
                inflight_ += to_submit;
            }
            // Derive to_submit from the ring itself: entries the kernel has
            // not consumed yet (sq head..tail) — a previous partial/failed
            // enter leaves them queued and this naturally resubmits them.
            uint32_t pending_sq =
                load_acquire(sq_tail_) - load_acquire(sq_head_);
            if (pending_sq > 0 || inflight_load() > 0) {
                int rc = io_uring_enter(ring_fd_, pending_sq,
                                        /*min_complete=*/1,
                                        IORING_ENTER_GETEVENTS);
                if (rc < 0 && errno != EINTR && errno != EAGAIN &&
                    errno != EBUSY) {
                    fail_unsubmitted();
                    continue;
                }
            }
            reap();
        }
    }

    uint32_t inflight_load() {
        std::lock_guard<std::mutex> lk(mu_);
        return inflight_;
    }

    void reap() {
        uint32_t head = load_acquire(cq_head_);
        for (;;) {
            uint32_t tail = load_acquire(cq_tail_);
            if (head == tail) break;
            io_uring_cqe* cqe = &cqes_[head & cq_mask_];
            Chunk* c = reinterpret_cast<Chunk*>(cqe->user_data);
            int32_t res = cqe->res;
            ++head;
            store_release(cq_head_, head);
            if (res == -EINTR || res == -EAGAIN) {
                requeue(c);  // retry whole chunk
            } else if (res <= 0) {
                complete_chunk(c, /*err=*/true);
            } else if (res < c->count) {
                c->buf += res;
                c->offset += res;
                c->count -= res;
                requeue(c);  // short I/O: finish the remainder
            } else {
                complete_chunk(c, /*err=*/false);
            }
            {
                std::lock_guard<std::mutex> lk(mu_);
                if (inflight_ > 0) --inflight_;
            }
        }
    }

    void requeue(Chunk* c) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            chunks_.push_front(std::move(*c));
        }
        delete c;
    }

    void complete_chunk(Chunk* c, bool err) {
        auto req = c->req;
        if (err) req->errors.fetch_add(1);
        int64_t prev = req->pending_chunks.fetch_sub(1);
        if (prev <= 0) {
            // already force-completed by the failure path; a late CQE for a
            // kernel-accepted op must not re-run completion bookkeeping
            req->pending_chunks.fetch_add(1);
        } else if (prev == 1) {
            if (req->fd >= 0) ::close(req->fd);
            req->fd = -1;
            std::lock_guard<std::mutex> lk(req->mu);
            req->cv.notify_all();
        }
        delete c;
    }

    // io_uring_enter failed non-retryably: ops the kernel ALREADY accepted
    // will still post CQEs (reap handles them normally), but SQEs it never
    // consumed and chunks never staged would wait forever — fail those so
    // waiters unblock with an error instead of hanging (matches reference
    // aio error propagation).
    void fail_unsubmitted() {
        reap();  // drain whatever did complete first
        std::lock_guard<std::mutex> lk(mu_);
        // drop ring entries the kernel never consumed: rewind our tail to
        // the kernel's head and fail their chunks (user_data owns them)
        uint32_t khead = load_acquire(sq_head_);
        uint32_t tail = load_acquire(sq_tail_);
        for (uint32_t i = khead; i != tail; ++i) {
            io_uring_sqe* sqe = &sqes_[sq_array_[i & sq_mask_]];
            complete_chunk(reinterpret_cast<Chunk*>(sqe->user_data),
                           /*err=*/true);
            if (inflight_ > 0) --inflight_;
        }
        store_release(sq_tail_, khead);
        // fail everything still queued host-side
        for (auto& c : chunks_)
            complete_chunk(new Chunk(std::move(c)), /*err=*/true);
        chunks_.clear();
    }

    static uint32_t load_acquire(uint32_t* p) {
        return __atomic_load_n(p, __ATOMIC_ACQUIRE);
    }
    static void store_release(uint32_t* p, uint32_t v) {
        __atomic_store_n(p, v, __ATOMIC_RELEASE);
    }

    int64_t block_size_;
    int queue_depth_;
    bool o_direct_;
    int ring_fd_ = -1;
    unsigned sq_entries_ = 0, cq_entries_ = 0;
    void* sq_ring_ = nullptr;
    void* cq_ring_ = nullptr;
    io_uring_sqe* sqes_ = nullptr;
    size_t sq_map_sz_ = 0, cq_map_sz_ = 0, sqes_sz_ = 0;
    uint32_t *sq_head_ = nullptr, *sq_tail_ = nullptr, *sq_array_ = nullptr;
    uint32_t *cq_head_ = nullptr, *cq_tail_ = nullptr;
    uint32_t sq_mask_ = 0, cq_mask_ = 0;
    io_uring_cqe* cqes_ = nullptr;

    bool stop_ = false;
    std::mutex mu_;
    std::condition_variable cv_;
    std::deque<Chunk> chunks_;
    std::map<int64_t, std::shared_ptr<Request>> requests_;
    int64_t next_id_ = 1;
    uint32_t inflight_ = 0;
    std::thread driver_;
};

}  // namespace

extern "C" {

int ds_uring_available() { return UringEngine::available() ? 1 : 0; }

void* ds_uring_handle_new(int64_t block_size, int queue_depth, int o_direct) {
    try {
        return new UringEngine(block_size, queue_depth, o_direct != 0);
    } catch (...) {
        return nullptr;
    }
}

void ds_uring_handle_free(void* h) { delete static_cast<UringEngine*>(h); }

int64_t ds_uring_submit_read(void* h, const char* path, void* buf,
                             int64_t count, int64_t offset) {
    return static_cast<UringEngine*>(h)->submit(path, buf, count, offset,
                                                false);
}

int64_t ds_uring_submit_write(void* h, const char* path, void* buf,
                              int64_t count, int64_t offset) {
    return static_cast<UringEngine*>(h)->submit(path, buf, count, offset,
                                                true);
}

int ds_uring_wait(void* h, int64_t req_id) {
    return static_cast<UringEngine*>(h)->wait(req_id);
}

int64_t ds_uring_pending(void* h) {
    return static_cast<UringEngine*>(h)->pending();
}

int ds_uring_pread(void* h, const char* path, void* buf, int64_t count,
                   int64_t offset) {
    auto* e = static_cast<UringEngine*>(h);
    return e->wait(e->submit(path, buf, count, offset, false));
}

int ds_uring_pwrite(void* h, const char* path, void* buf, int64_t count,
                    int64_t offset) {
    auto* e = static_cast<UringEngine*>(h);
    return e->wait(e->submit(path, buf, count, offset, true));
}

}  // extern "C"
