// Native client for the kma_tpu devserve daemon (kma_tpu/devserve.py):
// the persistent device session holding the device-resident index and the
// compiled scan executables (the -shm analog, shm.c:51 role).  The CLI
// driver ships step-2 read batches over the daemon's unix socket and
// keeps the rest of the run native.
#ifndef KMA_DEVCLIENT_H
#define KMA_DEVCLIENT_H

#include <cstdint>
#include <vector>

struct DevConn;

// Connect + hello identity check against the daemon serving db_prefix.
// Returns nullptr when there is no live, matching daemon.
DevConn *kdev_connect(const char *db_prefix);
void kdev_close(DevConn *c);

// One in-flight dense request at a time per extra slot: send is
// fire-and-forget, recv blocks for the matching response (FIFO), so the
// caller can pipeline batch k+1's send before batch k's recv.  Dense
// requests carry the "pipeline" flag: the daemon DEFERS each response
// until the next request's device work is dispatched (cross-request
// overlap); the caller must send a flush at end of stream to release
// the final response, then read the flush ack after draining.
bool kdev_dense_send(DevConn *c, const uint8_t *codes,
                     const int32_t *lengths, int n, int l, int M, int MM,
                     int U, int W1, bool exhaustive, bool has_proxi,
                     double proxi);
bool kdev_flush_send(DevConn *c);
bool kdev_flush_recv(DevConn *c);
bool kdev_dense_recv(DevConn *c, std::vector<int32_t> &scores,
                     std::vector<uint8_t> &modes,
                     std::vector<uint8_t> &over,
                     std::vector<int32_t> &counts,
                     std::vector<int32_t> &flat);

// Chain op: per-window hash probes for both strands (the ONT/default
// chain scan and the HMM scan feed on these).  The reply rows are
// list ids; kdev_chain_recv maps them through the hello-delivered
// voff_map so the caller gets value offsets (-1 = miss/invalid).
bool kdev_chain_send(DevConn *c, const uint8_t *codes,
                     const int32_t *lengths, int n, int l);
bool kdev_chain_recv(DevConn *c, std::vector<long long> &voff_f,
                     std::vector<long long> &voff_r, long long *w_out);

#endif
