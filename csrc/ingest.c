/* Native FPGA UDP ingest shim.
 *
 * Equivalent of the reference's receiver + producer thread
 * (src/fpga/receiver.cpp:28-58, src/fpga/pipeline.cpp:243-296): one packet
 * per sample at ~48828 pkt/s per FPGA link.  The per-packet recv() loop of
 * the reference becomes a recvmmsg() batch loop on a dedicated thread,
 * demuxing (daisy-chain column unflip, pipeline.cpp:277-291) and
 * normalizing int24 -> float (pipeline.h:25) straight into a ring of
 * [n_sensors, block_size] float blocks the Python side copies out of.
 *
 * Unlike the reference's always-overwritten mmap ring (streams.hpp:152-182,
 * readers race the producer), the ring here hands out *complete* blocks
 * with sequence numbers; overruns drop the oldest block and are counted.
 *
 * Build: make -C csrc   (produces libingest.so; loaded via ctypes from
 * beamforming_lk_tpu/io/native.py)
 */

#define _GNU_SOURCE
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#define MAX_N_SENSORS 256          /* receiver.h:17 */
#define HEADER_SIZE 8
#define PACKET_SIZE (HEADER_SIZE + 4 * MAX_N_SENSORS)
#define MAX_VALUE_FLOAT 8388608.0f /* 2^23, pipeline.h:25 */
#define RECV_BATCH 64
#define COLUMNS 8

typedef struct Ingest {
    int fd;
    int n_sensors;
    int block_size;
    int n_slots;
    int running;
    int column_map[MAX_N_SENSORS];
    float *slots;            /* [n_slots][n_sensors][block_size] */
    uint64_t *slot_seq;      /* sequence number of each filled slot */
    uint64_t next_seq;       /* next block sequence to be produced */
    uint64_t read_seq;       /* next block sequence the consumer wants */
    uint64_t packets_received;
    uint64_t blocks_produced;
    uint64_t blocks_dropped;
    uint32_t last_counter;
    uint64_t counter_gaps;
    int fill;                /* samples filled in the in-progress block */
    pthread_t thread;
    pthread_mutex_t lock;
    pthread_cond_t cond;
} Ingest;

/* pipeline.cpp:277-291: groups of COLUMNS alternate reversed/normal,
 * starting reversed. */
static void build_column_map(int *map, int n_sensors, int column_flip) {
    for (int s = 0; s < n_sensors; s++) {
        int group = s / COLUMNS;
        if (column_flip && (group % 2) == 0)
            map[s] = COLUMNS * (1 + group) - 1 - (s % COLUMNS);
        else
            map[s] = s;
    }
}

static void *ingest_thread(void *arg) {
    Ingest *ig = (Ingest *)arg;
    const int T = ig->block_size;
    const int C = ig->n_sensors;

    static __thread uint8_t bufs[RECV_BATCH][PACKET_SIZE];
    struct mmsghdr msgs[RECV_BATCH];
    struct iovec iovs[RECV_BATCH];
    for (int i = 0; i < RECV_BATCH; i++) {
        iovs[i].iov_base = bufs[i];
        iovs[i].iov_len = PACKET_SIZE;
        memset(&msgs[i], 0, sizeof(msgs[i]));
        msgs[i].msg_hdr.msg_iov = &iovs[i];
        msgs[i].msg_hdr.msg_iovlen = 1;
    }
    /* recvmmsg's timeout argument is only evaluated after a datagram
     * arrives (Linux quirk) — an idle socket would block forever and wedge
     * ingest_close's pthread_join.  Poll with a timeout instead and keep
     * the socket non-blocking. */
    struct pollfd pfd = {ig->fd, POLLIN, 0};

    while (__atomic_load_n(&ig->running, __ATOMIC_ACQUIRE)) {
        int pr = poll(&pfd, 1, 50 /* ms */);
        if (pr <= 0) {
            if (pr < 0 && errno != EINTR)
                break;
            continue;
        }
        int n = recvmmsg(ig->fd, msgs, RECV_BATCH, MSG_DONTWAIT, NULL);
        if (n <= 0) {
            if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                errno != EINTR)
                break;
            continue;
        }
        uint64_t slot_idx = ig->next_seq % ig->n_slots;
        float *slot = ig->slots + slot_idx * (size_t)C * T;
        for (int i = 0; i < n; i++) {
            if (msgs[i].msg_len != PACKET_SIZE)
                continue; /* malformed: skip, as the reference breaks (pipeline.cpp:264) */
            const uint8_t *pkt = bufs[i];
            uint32_t counter;
            memcpy(&counter, pkt + 4, 4);
            if (ig->packets_received > 0 &&
                counter != (uint32_t)(ig->last_counter + 1))
                ig->counter_gaps++;
            ig->last_counter = counter;
            ig->packets_received++;

            const int32_t *stream = (const int32_t *)(pkt + HEADER_SIZE);
            int t = ig->fill;
            for (int c = 0; c < C; c++)
                slot[(size_t)c * T + t] =
                    (float)stream[ig->column_map[c]] / MAX_VALUE_FLOAT;
            ig->fill++;
            if (ig->fill == T) {
                pthread_mutex_lock(&ig->lock);
                ig->slot_seq[slot_idx] = ig->next_seq;
                ig->next_seq++;
                ig->blocks_produced++;
                /* overrun: the consumer lost the block that this slot will
                 * overwrite next */
                if (ig->next_seq > ig->read_seq + ig->n_slots) {
                    ig->blocks_dropped += ig->next_seq - ig->n_slots - ig->read_seq;
                    ig->read_seq = ig->next_seq - ig->n_slots;
                }
                pthread_cond_signal(&ig->cond);
                pthread_mutex_unlock(&ig->lock);
                ig->fill = 0;
                slot_idx = ig->next_seq % ig->n_slots;
                slot = ig->slots + slot_idx * (size_t)C * T;
            }
        }
    }
    return NULL;
}

Ingest *ingest_open(const char *address, int port, int n_sensors,
                    int block_size, int n_slots, int column_flip) {
    if (n_sensors <= 0 || n_sensors > MAX_N_SENSORS || block_size <= 0 ||
        n_slots < 2)
        return NULL;
    Ingest *ig = calloc(1, sizeof(Ingest));
    if (!ig)
        return NULL;
    ig->n_sensors = n_sensors;
    ig->block_size = block_size;
    ig->n_slots = n_slots;
    build_column_map(ig->column_map, n_sensors, column_flip);
    ig->slots = calloc((size_t)n_slots * n_sensors * block_size, sizeof(float));
    ig->slot_seq = calloc(n_slots, sizeof(uint64_t));
    if (!ig->slots || !ig->slot_seq)
        goto fail;

    ig->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (ig->fd < 0)
        goto fail;
    int rcvbuf = 8 * 1024 * 1024;
    setsockopt(ig->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    int reuse = 1;
    setsockopt(ig->fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
    struct sockaddr_in addr = {0};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr =
        address && *address ? inet_addr(address) : INADDR_ANY;
    if (bind(ig->fd, (struct sockaddr *)&addr, sizeof(addr)) < 0)
        goto fail;
    fcntl(ig->fd, F_SETFL, fcntl(ig->fd, F_GETFL, 0) | O_NONBLOCK);

    pthread_mutex_init(&ig->lock, NULL);
    pthread_cond_init(&ig->cond, NULL);
    ig->running = 1;
    if (pthread_create(&ig->thread, NULL, ingest_thread, ig) != 0)
        goto fail;
    return ig;
fail:
    if (ig->fd > 0)
        close(ig->fd);
    free(ig->slots);
    free(ig->slot_seq);
    free(ig);
    return NULL;
}

/* Copy the next unread block into out[n_sensors * block_size].
 * Returns its sequence number, or -1 on timeout. */
int64_t ingest_next_block(Ingest *ig, float *out, double timeout_s) {
    struct timespec deadline;
    clock_gettime(CLOCK_REALTIME, &deadline);
    deadline.tv_sec += (time_t)timeout_s;
    deadline.tv_nsec += (long)((timeout_s - (time_t)timeout_s) * 1e9);
    if (deadline.tv_nsec >= 1000000000L) {
        deadline.tv_sec++;
        deadline.tv_nsec -= 1000000000L;
    }
    pthread_mutex_lock(&ig->lock);
    while (ig->read_seq >= ig->next_seq) {
        if (pthread_cond_timedwait(&ig->cond, &ig->lock, &deadline) ==
            ETIMEDOUT) {
            pthread_mutex_unlock(&ig->lock);
            return -1;
        }
    }
    uint64_t seq = ig->read_seq;
    uint64_t slot_idx = seq % ig->n_slots;
    /* The slot can only be overwritten once next_seq wraps past it; the
     * overrun accounting above keeps read_seq within the ring. */
    memcpy(out, ig->slots + slot_idx * (size_t)ig->n_sensors * ig->block_size,
           (size_t)ig->n_sensors * ig->block_size * sizeof(float));
    ig->read_seq++;
    pthread_mutex_unlock(&ig->lock);
    return (int64_t)seq;
}

void ingest_stats(Ingest *ig, uint64_t *received, uint64_t *produced,
                  uint64_t *dropped, uint64_t *gaps) {
    pthread_mutex_lock(&ig->lock);
    if (received)
        *received = ig->packets_received;
    if (produced)
        *produced = ig->blocks_produced;
    if (dropped)
        *dropped = ig->blocks_dropped;
    if (gaps)
        *gaps = ig->counter_gaps;
    pthread_mutex_unlock(&ig->lock);
}

int ingest_port(Ingest *ig) {
    struct sockaddr_in addr;
    socklen_t len = sizeof(addr);
    if (getsockname(ig->fd, (struct sockaddr *)&addr, &len) < 0)
        return -1;
    return ntohs(addr.sin_port);
}

void ingest_close(Ingest *ig) {
    if (!ig)
        return;
    __atomic_store_n(&ig->running, 0, __ATOMIC_RELEASE);
    pthread_join(ig->thread, NULL);
    close(ig->fd);
    pthread_mutex_destroy(&ig->lock);
    pthread_cond_destroy(&ig->cond);
    free(ig->slots);
    free(ig->slot_seq);
    free(ig);
}
