// ds_aio — threaded async block I/O library backing NVMe/disk offload.
//
// TPU-native rebuild of the reference's csrc/aio (libaio-based
// deepspeed_aio_thread.cpp / deepspeed_py_io_handle.cpp): a pool of I/O
// threads services read/write requests; each request is split into
// block_size chunks fanned out across the pool (the reference's
// queue-depth×block-size parallel submission), completion is tracked
// per-request so Python can overlap compute with swap traffic and wait()
// only when the tensor is needed.
//
// Exposed as a plain C API for ctypes (no pybind11 in this image).
// Alignment: buffers are caller-owned (numpy); we use plain pread/pwrite on
// a per-thread fd (O_DIRECT needs aligned userland buffers — opt-in flag).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
    std::atomic<int64_t> pending_chunks{0};
    std::atomic<int64_t> errors{0};
    bool write = false;
    std::mutex mu;
    std::condition_variable cv;
};

struct Chunk {
    std::shared_ptr<Request> req;
    std::string path;
    char* buf;
    int64_t count;
    int64_t offset;
    bool write;
};

class AioHandle {
  public:
    AioHandle(int64_t block_size, int queue_depth, int n_threads,
              bool o_direct)
        : block_size_(block_size > 0 ? block_size : (1 << 20)),
          queue_depth_(queue_depth > 0 ? queue_depth : 32),
          o_direct_(o_direct), stop_(false) {
        if (n_threads <= 0) n_threads = 4;
        for (int i = 0; i < n_threads; ++i)
            workers_.emplace_back([this] { worker_loop(); });
    }

    ~AioHandle() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }

    int64_t submit(const char* path, void* buf, int64_t count, int64_t offset,
                   bool write) {
        auto req = std::make_shared<Request>();
        req->write = write;
        int64_t n_chunks = (count + block_size_ - 1) / block_size_;
        if (n_chunks == 0) n_chunks = 1;
        req->pending_chunks.store(n_chunks);
        int64_t id;
        {
            std::unique_lock<std::mutex> lk(mu_);
            id = next_id_++;
            requests_[id] = req;
            for (int64_t c = 0; c < n_chunks; ++c) {
                // backpressure: queue_depth bounds in-flight chunks; workers
                // notify as they drain
                cv_.wait(lk, [&] {
                    return stop_ ||
                           static_cast<int>(queue_.size()) < queue_depth_;
                });
                if (stop_) {  // shutting down: unqueued chunks won't run
                    req->pending_chunks.fetch_sub(n_chunks - c);
                    break;
                }
                int64_t chunk_off = c * block_size_;
                int64_t chunk_len = std::min(block_size_, count - chunk_off);
                if (chunk_len <= 0) chunk_len = 0;
                queue_.push_back(Chunk{req, path,
                                       static_cast<char*>(buf) + chunk_off,
                                       chunk_len, offset + chunk_off, write});
                cv_.notify_one();
            }
        }
        cv_.notify_all();
        return id;
    }

    // returns 0 on success, -1 on I/O error
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
    int n_threads() const { return static_cast<int>(workers_.size()); }

  private:
    void worker_loop() {
        for (;;) {
            Chunk chunk;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                chunk = std::move(queue_.front());
                queue_.pop_front();
                cv_.notify_all();  // wake submitters waiting for queue space
            }
            run_chunk(chunk);
        }
    }

    void run_chunk(Chunk& chunk) {
        int flags = chunk.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
        // same per-request contract as the io_uring engine: O_DIRECT only
        // when (buffer, offset, length) are 4KiB-aligned, silent buffered
        // fallback otherwise — an unaligned request must not EINVAL just
        // because this engine was selected
        constexpr int64_t kAlign = 4096;
        if (o_direct_ && chunk.count > 0 &&
            reinterpret_cast<uintptr_t>(chunk.buf) % kAlign == 0 &&
            chunk.offset % kAlign == 0 && chunk.count % kAlign == 0)
            flags |= O_DIRECT;
#endif
        bool failed = false;
        int fd = ::open(chunk.path.c_str(), flags, 0644);
        if (fd < 0) {
            failed = true;
        } else {
            int64_t done = 0;
            while (done < chunk.count) {
                ssize_t n =
                    chunk.write
                        ? ::pwrite(fd, chunk.buf + done, chunk.count - done,
                                   chunk.offset + done)
                        : ::pread(fd, chunk.buf + done, chunk.count - done,
                                  chunk.offset + done);
                if (n <= 0) {
                    failed = true;
                    break;
                }
                done += n;
            }
            ::close(fd);
        }
        if (failed) chunk.req->errors.fetch_add(1);
        if (chunk.req->pending_chunks.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lk(chunk.req->mu);
            chunk.req->cv.notify_all();
        }
    }

    int64_t block_size_;
    int queue_depth_;
    bool o_direct_;
    bool stop_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::deque<Chunk> queue_;
    std::map<int64_t, std::shared_ptr<Request>> requests_;
    int64_t next_id_ = 1;
    std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int64_t block_size, int queue_depth, int n_threads,
                        int o_direct) {
    return new AioHandle(block_size, queue_depth, n_threads, o_direct != 0);
}

void ds_aio_handle_free(void* h) { delete static_cast<AioHandle*>(h); }

int64_t ds_aio_submit_read(void* h, const char* path, void* buf,
                           int64_t count, int64_t offset) {
    return static_cast<AioHandle*>(h)->submit(path, buf, count, offset,
                                              false);
}

int64_t ds_aio_submit_write(void* h, const char* path, void* buf,
                            int64_t count, int64_t offset) {
    return static_cast<AioHandle*>(h)->submit(path, buf, count, offset, true);
}

int ds_aio_wait(void* h, int64_t req_id) {
    return static_cast<AioHandle*>(h)->wait(req_id);
}

int64_t ds_aio_pending(void* h) {
    return static_cast<AioHandle*>(h)->pending();
}

// synchronous convenience (submit+wait)
int ds_aio_pread(void* h, const char* path, void* buf, int64_t count,
                 int64_t offset) {
    auto* handle = static_cast<AioHandle*>(h);
    return handle->wait(handle->submit(path, buf, count, offset, false));
}

int ds_aio_pwrite(void* h, const char* path, void* buf, int64_t count,
                  int64_t offset) {
    auto* handle = static_cast<AioHandle*>(h);
    return handle->wait(handle->submit(path, buf, count, offset, true));
}

int64_t ds_aio_block_size(void* h) {
    return static_cast<AioHandle*>(h)->block_size();
}
int ds_aio_queue_depth(void* h) {
    return static_cast<AioHandle*>(h)->queue_depth();
}
int ds_aio_thread_count(void* h) {
    return static_cast<AioHandle*>(h)->n_threads();
}

}  // extern "C"
