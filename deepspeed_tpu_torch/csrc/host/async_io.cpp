// Asynchronous host file IO for tensor spill (ZeRO-Infinity NVMe offload).
//
// TPU-native equivalent of the reference's csrc/aio/ tree
// (py_lib/py_ds_aio.cpp:16-22 binds `aio_read`/`aio_write`/`aio_handle`;
// common/deepspeed_aio_utils.cpp does the libaio submission). Role: move
// parameter / optimizer-state shards between host RAM and local SSD with
// enough parallelism to saturate NVMe, off the Python thread.
//
// Design: a fixed worker-thread pool consuming a request queue; each request
// is a contiguous (pread/pwrite, fd-per-request) transfer, internally split
// into block_size chunks that are striped across the pool — the same
// parallelism knobs as the reference (thread_count x queue_depth x
// block_size, csrc/aio/common/deepspeed_aio_types.h). Plain p{read,write}
// on a thread pool rather than io_uring/libaio keeps it portable inside
// sandboxes while still overlapping IO with compute; the ABI leaves room to
// swap the backend.
//
// C ABI (ctypes-bound):
//   ds_aio_handle_create(block_size, n_threads) -> handle*
//   ds_aio_pread / ds_aio_pwrite(handle, path, buf, nbytes, file_offset)
//       -> request id (async; buffer must stay alive until waited)
//   ds_aio_wait(handle, req_id) -> bytes transferred (<0 on error)
//   ds_aio_wait_all(handle) -> 0 ok / <0 first error
//   ds_aio_handle_destroy(handle*)

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
    int64_t id;
    bool is_write;
    std::string path;
    char* buf;
    int64_t nbytes;
    int64_t file_offset;
    // completion tracking
    std::atomic<int64_t> remaining_chunks{0};
    std::atomic<int64_t> bytes_done{0};
    std::atomic<int64_t> error{0};
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;

    void chunk_finished(int64_t bytes, int64_t err, int64_t total_chunks) {
        if (err) error.store(err);
        bytes_done.fetch_add(bytes);
        if (remaining_chunks.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lock(mu);
            done = true;
            cv.notify_all();
        }
        (void)total_chunks;
    }
};

struct Chunk {
    std::shared_ptr<Request> req;
    int64_t offset;  // within the request
    int64_t nbytes;
};

struct AioHandle {
    int64_t block_size;
    std::vector<std::thread> workers;
    std::deque<Chunk> queue;
    std::mutex mu;
    std::condition_variable cv;
    bool shutting_down = false;
    std::atomic<int64_t> next_id{1};
    std::unordered_map<int64_t, std::shared_ptr<Request>> inflight;
    std::mutex inflight_mu;

    void worker_loop() {
        for (;;) {
            Chunk chunk;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [&] { return shutting_down || !queue.empty(); });
                if (queue.empty()) return;  // shutting down
                chunk = std::move(queue.front());
                queue.pop_front();
            }
            run_chunk(chunk);
        }
    }

    static void run_chunk(const Chunk& chunk) {
        Request& r = *chunk.req;
        int flags = r.is_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
        int fd = ::open(r.path.c_str(), flags, 0644);
        if (fd < 0) {
            r.chunk_finished(0, -errno, 0);
            return;
        }
        char* p = r.buf + chunk.offset;
        int64_t left = chunk.nbytes;
        int64_t off = r.file_offset + chunk.offset;
        int64_t moved = 0;
        int64_t err = 0;
        while (left > 0) {
            ssize_t got = r.is_write ? ::pwrite(fd, p, left, off)
                                     : ::pread(fd, p, left, off);
            if (got <= 0) {
                err = got == 0 ? -EIO : -errno;
                break;
            }
            p += got;
            off += got;
            left -= got;
            moved += got;
        }
        ::close(fd);
        r.chunk_finished(moved, err, 0);
    }

    int64_t submit(bool is_write, const char* path, char* buf, int64_t nbytes,
                   int64_t file_offset) {
        auto req = std::make_shared<Request>();
        req->id = next_id.fetch_add(1);
        req->is_write = is_write;
        req->path = path;
        req->buf = buf;
        req->nbytes = nbytes;
        req->file_offset = file_offset;
        int64_t n_chunks =
            nbytes == 0 ? 1 : (nbytes + block_size - 1) / block_size;
        req->remaining_chunks.store(n_chunks);
        {
            std::lock_guard<std::mutex> lock(inflight_mu);
            inflight[req->id] = req;
        }
        {
            std::lock_guard<std::mutex> lock(mu);
            if (nbytes == 0) {
                // degenerate request: complete immediately via one no-op chunk
                queue.push_back(Chunk{req, 0, 0});
            } else {
                for (int64_t c = 0; c < n_chunks; ++c) {
                    int64_t off = c * block_size;
                    queue.push_back(Chunk{
                        req, off, std::min(block_size, nbytes - off)});
                }
            }
        }
        cv.notify_all();
        return req->id;
    }

    int64_t wait(int64_t req_id) {
        std::shared_ptr<Request> req;
        {
            std::lock_guard<std::mutex> lock(inflight_mu);
            auto it = inflight.find(req_id);
            if (it == inflight.end()) return -1;
            req = it->second;
        }
        {
            std::unique_lock<std::mutex> lock(req->mu);
            req->cv.wait(lock, [&] { return req->done; });
        }
        {
            std::lock_guard<std::mutex> lock(inflight_mu);
            inflight.erase(req_id);
        }
        int64_t err = req->error.load();
        return err ? err : req->bytes_done.load();
    }

    int64_t wait_all() {
        std::vector<int64_t> ids;
        {
            std::lock_guard<std::mutex> lock(inflight_mu);
            for (auto& kv : inflight) ids.push_back(kv.first);
        }
        int64_t first_err = 0;
        for (int64_t id : ids) {
            int64_t got = wait(id);
            if (got < 0 && first_err == 0) first_err = got;
        }
        return first_err;
    }
};

}  // namespace

extern "C" {

void* ds_aio_handle_create(int64_t block_size, int n_threads) {
    auto* h = new AioHandle();
    h->block_size = block_size > 0 ? block_size : (1 << 20);
    if (n_threads <= 0) n_threads = 8;
    for (int i = 0; i < n_threads; ++i) {
        h->workers.emplace_back([h] { h->worker_loop(); });
    }
    return h;
}

void ds_aio_handle_destroy(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    h->wait_all();
    {
        std::lock_guard<std::mutex> lock(h->mu);
        h->shutting_down = true;
    }
    h->cv.notify_all();
    for (auto& t : h->workers) t.join();
    delete h;
}

int64_t ds_aio_pread(void* handle, const char* path, void* buf, int64_t nbytes,
                     int64_t file_offset) {
    return static_cast<AioHandle*>(handle)->submit(
        false, path, static_cast<char*>(buf), nbytes, file_offset);
}

int64_t ds_aio_pwrite(void* handle, const char* path, void* buf,
                      int64_t nbytes, int64_t file_offset) {
    return static_cast<AioHandle*>(handle)->submit(
        true, path, static_cast<char*>(buf), nbytes, file_offset);
}

int64_t ds_aio_wait(void* handle, int64_t req_id) {
    return static_cast<AioHandle*>(handle)->wait(req_id);
}

int64_t ds_aio_wait_all(void* handle) {
    return static_cast<AioHandle*>(handle)->wait_all();
}

}  // extern "C"
