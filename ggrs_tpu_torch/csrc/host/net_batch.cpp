// Kernel-batched UDP datapath: recvmmsg/sendmmsg ring buffers around one
// bound non-blocking UDP fd (DESIGN.md §15).
//
// The Python shuttle pays one syscall PLUS one Python→C round trip per
// datagram on both sides of the tick crossing; at B matches × peers plus
// the spectator fan-out that is hundreds-to-thousands of sendto/recvfrom
// calls per pool tick.  A NetBatch replaces them with (typically) one
// recvmmsg and one sendmmsg per slot per tick: preallocated iovec +
// sockaddr slabs, datagrams copied once into a per-tick accumulation slab
// so the session bank can route them by source address without holding the
// kernel rings.
//
// SEMANTICS mirror ggrs_tpu_torch.net.sockets.UdpNonBlockingSocket exactly:
//  - receive drains until EAGAIN/EWOULDBLOCK; ECONNRESET/ECONNREFUSED
//    between datagrams is skipped (the post-sendto ICMP echo some OSes
//    surface), anything else is fatal;
//  - transient send errnos (the _TRANSIENT_SEND_ERRNOS set: ENETUNREACH,
//    EHOSTUNREACH, ECONNREFUSED, ENETDOWN, EHOSTDOWN, ENOBUFS, EAGAIN,
//    EWOULDBLOCK) count the datagram as lost — the endpoint protocol's
//    redundant sends already cover loss — and the flush continues;
//  - EMSGSIZE / EPERM and friends are deterministic local faults: the
//    flush aborts fatally (the bank turns that into a per-slot fault, the
//    same blast radius a raising socket.sendto has on the Python path);
//  - datagrams above the 4096-byte receive buffer truncate, datagrams
//    above the 508-byte ideal UDP size are counted (never blocked).
//
// The NetBatch is owned by the Python pool (ggrs_net_attach/free); the
// session bank only borrows the pointer (ggrs_bank_attach_socket).  One
// NetBatch serves one fd and is single-threaded, like everything else in
// the host loop.
//
// TEST SEAMS (observational; zero cost when unused):
//  - capture tee: every staged datagram is mirrored into a drainable
//    buffer so parity fuzzes can pin the batched path's full wire byte
//    sequence — content AND send order — against the Python shuttle;
//  - errno injection: the next N staged datagrams fail with a chosen
//    errno before reaching sendmmsg (scripts/chaos.py --fault socket).
//
// Non-Linux builds compile the same extern-C surface as stubs
// (ggrs_net_supported() == 0); the pool then keeps the Python shuttle —
// the fallback matrix in DESIGN.md §15.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

// return codes (mirrored in ggrs_tpu_torch/net/_native.py)
constexpr int kNetOk = 0;
constexpr int kNetErrUnsupported = -80;
constexpr int kNetErrFatal = -81;
constexpr int kNetErrBadArgs = -82;
constexpr int kNetErrBufferTooSmall = -11;  // wire_common kErrBufferTooSmall

// sockets.py RECV_BUFFER_SIZE / IDEAL_MAX_UDP_PACKET_SIZE
constexpr size_t kRecvBufSize = 4096;
constexpr size_t kIdealMaxUdp = 508;

// ---- one-shot batched send table (descriptor plane, DESIGN.md §21) ------
// ggrs_net_send_table record stride: non-attached sockets (native_io off,
// or sockets that could not attach) route their whole tick's outbound
// through ONE crossing — per datagram: i32 fd, u32 ip (sin_addr.s_addr as
// stored), u16 port (host order), u16 pad, u32 off, u32 len (off/len jump
// into the shared payload, usually the tick output buffer itself).
// Records for one fd must be contiguous (the pool emits per-slot runs);
// stride and field order mirrored by _native.NET_SEND_FIELDS.
constexpr size_t kSendStride = 20;

// ---- datapath gen 2 (DESIGN.md §23) -------------------------------------
// ggrs_net_recv_table: ONE crossing drains every non-attached fd-backed
// socket of the pool.  Inputs: an fd descriptor table (kFdStride bytes per
// entry: i32 fd, i32 slot; slot == -1 marks a shared DISPATCH fd whose
// datagrams are demuxed by source address through the route table) and a
// route table sorted by (ip, port) (kRouteStride bytes per entry: u32 ip,
// u16 port, u16 pad, i32 slot).  Output: a packed record table
// (kRecvStride bytes per datagram: i32 slot, i32 fd_idx, u32 ip, u16 port,
// u16 seg, u32 off, u32 len) whose off/len index the caller's slab.  `seg`
// is the segment index when a GRO-coalesced datagram was split back into
// its wire datagrams (§23d) — 0 for ordinary datagrams, 0..n-1 across one
// coalesced train (same stride, the u16 that used to be padding).
constexpr size_t kRecvStride = 24;
constexpr size_t kRouteStride = 12;
constexpr size_t kFdStride = 8;

// send-table record flags (the u16 at record offset 10, formerly pad):
// bit0 marks a DISPATCH record — the fd is shared by many slots, so a
// fatal errno faults only THIS record (reported, skipped, run continues)
// instead of abandoning the rest of the fd's run.
constexpr uint16_t kSendFlagDispatch = 1;

// ggrs_net_send_table stats words: {sent, transient_errors, oversized,
// gso_sends, gso_segments} — mirrored as _native.NET_SEND_STATS.
constexpr int kSendTableStats = 5;

// ggrs_net_recv_table stats words: {recv_calls, datagrams, unroutable,
// backpressure_stops} + the 8-bucket batch-size histogram, then the GRO
// tail appended AFTER the histogram so existing indices never move:
// [12] gro_datagrams (coalesced trains split), [13] gro_segments (wire
// datagrams recovered from them) — mirrored as _native.NET_RECV_TABLE_STATS.
constexpr int kRecvTableStats = 14;
constexpr int kStGroDgrams = 12;
constexpr int kStGroSegs = 13;

// stat slots (mirrored as _native.IO_STAT_FIELDS + two 8-bucket
// histograms; 22 u64 total, the per-slot io tail of ggrs_bank_stats)
enum NetStat : int {
  kStRecvCalls = 0,   // recvmmsg invocations (incl. the EAGAIN probe)
  kStRecvDgrams = 1,  // datagrams received
  kStSendCalls = 2,   // sendmmsg invocations
  kStSendDgrams = 3,  // datagrams handed to the kernel
  kStSendErrors = 4,  // transient send failures counted as loss
  kStOversized = 5,   // staged datagrams above kIdealMaxUdp
  kStRecvHist0 = 6,   // recv batch-size buckets: 1,2,4,8,16,32,64,+inf
  kStSendHist0 = 14,  // send batch-size buckets, same bounds
  kNumNetStats = 22,
};

inline int batch_bucket(int n) {
  int b = 0, upper = 1;
  while (b < 7 && n > upper) {
    upper <<= 1;
    ++b;
  }
  return b;
}

}  // namespace

extern "C" {

// runtime stride probes (ggrs-verify pins these against the static
// layout contract, like ggrs_bank_hdr_stride on the bank side)
int ggrs_net_recv_stride(void) { return static_cast<int>(kRecvStride); }
int ggrs_net_route_stride(void) { return static_cast<int>(kRouteStride); }
int ggrs_net_fd_stride(void) { return static_cast<int>(kFdStride); }
int ggrs_net_send_stats_len(void) { return kSendTableStats; }
int ggrs_net_recv_stats_len(void) { return kRecvTableStats; }

}  // extern "C"

#if defined(__linux__)

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/udp.h>
#include <sys/socket.h>
#include <unistd.h>

// UDP_SEGMENT landed in linux 4.18; build against older headers still
// produces a working probe (the setsockopt simply fails on old kernels).
#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif
// UDP_GRO (receive-side coalescing) landed in linux 5.0; same old-header
// story as UDP_SEGMENT — the probe simply fails on kernels without it.
#ifndef UDP_GRO
#define UDP_GRO 104
#endif
#ifndef SOL_UDP
#define SOL_UDP 17
#endif

namespace {

bool transient_send_errno(int e) {
  // _TRANSIENT_SEND_ERRNOS in sockets.py, member for member.  EMSGSIZE and
  // EPERM are deliberately NOT here: deterministic local faults that every
  // retransmission would hit identically must fail loudly, not stall.
  switch (e) {
    case ENETUNREACH:
    case EHOSTUNREACH:
    case ECONNREFUSED:
    case ENETDOWN:
#ifdef EHOSTDOWN
    case EHOSTDOWN:
#endif
    case ENOBUFS:
    case EAGAIN:
#if EWOULDBLOCK != EAGAIN
    case EWOULDBLOCK:
#endif
      return true;
    default:
      return false;
  }
}

struct Dgram {
  uint32_t ip;    // sin_addr.s_addr, network byte order as stored
  uint16_t port;  // host byte order
  uint32_t off, len;  // slice into the owning slab
};

// ---- GSO capability (gen 2) ---------------------------------------------
// One-time per-process probe: can a UDP socket take the UDP_SEGMENT
// option on THIS kernel?  g_gso_mode is the caller-facing override
// (ggrs_net_set_gso): -1 auto (probe decides), 0 forced off, 1 forced on
// (still requires the probe — a kernel that refuses the option cannot be
// forced).
int g_gso_mode = -1;

int gso_probe() {
  static int cached = -1;
  if (cached >= 0) return cached;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) {
    cached = 0;
    return cached;
  }
  int seg = 1400;
  cached = setsockopt(fd, SOL_UDP, UDP_SEGMENT, &seg, sizeof(seg)) == 0;
  close(fd);
  return cached;
}

bool gso_active() { return g_gso_mode != 0 && gso_probe() != 0; }

// ---- GRO capability (gen 2, §23d) ---------------------------------------
// The receive-side mirror of the GSO probe: can a UDP socket take the
// UDP_GRO option on THIS kernel?  Unlike GSO (auto by default — the send
// path only ever gains from coalescing), the recv drain defaults OFF:
// gro_active() switches the drain onto the wide 16-message GRO ring,
// which trades per-syscall message count for train capacity, so it must
// be armed explicitly — the pool calls ggrs_net_set_gro(1) exactly when
// it flipped UDP_GRO on the hub fds the recv table covers.  Contract:
// 0 off (default), 1 on, -1 auto (probe-gated).  Sockets that never had
// UDP_GRO set produce no cmsg and decode exactly as before (minus the
// ordinary-datagram clamp, which preserves truncation parity).
int g_gro_mode = 0;

int gro_probe() {
  static int cached = -1;
  if (cached >= 0) return cached;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) {
    cached = 0;
    return cached;
  }
  int on = 1;
  cached = setsockopt(fd, SOL_UDP, UDP_GRO, &on, sizeof(on)) == 0;
  close(fd);
  return cached;
}

bool gro_active() {
  if (g_gro_mode == 0) return false;
  if (g_gro_mode == 1) return true;
  return gro_probe() != 0;
}

// route table binary search: entries sorted by (ip, port) as the packed
// u64 key below (the pool sorts the same way)
inline uint64_t route_key(uint32_t ip, uint16_t port) {
  return (static_cast<uint64_t>(ip) << 16) | port;
}

int32_t route_lookup(const uint8_t* routes, int n_routes, uint32_t ip,
                     uint16_t port) {
  uint64_t want = route_key(ip, port);
  int lo = 0, hi = n_routes - 1;
  while (lo <= hi) {
    int mid = lo + (hi - lo) / 2;
    const uint8_t* p = routes + static_cast<size_t>(mid) * kRouteStride;
    uint32_t rip = 0;
    for (int b = 0; b < 4; ++b) rip |= static_cast<uint32_t>(p[b]) << (8 * b);
    uint16_t rport = static_cast<uint16_t>(p[4] | (p[5] << 8));
    uint64_t key = route_key(rip, rport);
    if (key == want) {
      uint32_t slot = 0;
      for (int b = 0; b < 4; ++b) {
        slot |= static_cast<uint32_t>(p[8 + b]) << (8 * b);
      }
      return static_cast<int32_t>(slot);
    }
    if (key < want) {
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  return -1;
}

// send-table errno injection (scripts/chaos.py --fault socket, dispatch
// leg): record indices [at, at+count) of subsequent ggrs_net_send_table
// calls fail with `err` before any syscall, until count is exhausted.
int g_table_inject_errno = 0;
int64_t g_table_inject_at = 0;
int g_table_inject_count = 0;

struct NetBatch {
  int fd = -1;
  int vlen = 64;
  // receive rings (kernel-facing, reused every recvmmsg)
  std::vector<mmsghdr> rmsgs;
  std::vector<iovec> riov;
  std::vector<sockaddr_in> raddr;
  std::vector<uint8_t> rbuf;  // vlen * kRecvBufSize
  // per-tick accumulation (bank-facing: stable until the next recv_all)
  std::vector<uint8_t> rslab;
  std::vector<Dgram> rlist;
  // staged sends (flushed in stage order)
  std::vector<uint8_t> sslab;
  std::vector<Dgram> slist;
  std::vector<mmsghdr> smsgs;
  std::vector<iovec> siov;
  std::vector<sockaddr_in> saddr;
  uint64_t st[kNumNetStats] = {0};
  // test seams
  bool capture = false;
  std::vector<uint8_t> capture_buf;  // [u32 ip][u16 port][u32 len][bytes]*
  int inject_errno = 0;
  int inject_count = 0;
};

void put_u16le(std::vector<uint8_t>* b, uint16_t v) {
  b->push_back(v & 0xFF);
  b->push_back(v >> 8);
}

void put_u32le(std::vector<uint8_t>* b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xFF);
}

}  // namespace

extern "C" {

int ggrs_net_supported(void) { return 1; }

// Wrap a bound, non-blocking UDP fd.  The fd stays owned by the caller
// (the Python socket object); max_batch bounds each recvmmsg/sendmmsg
// window.  Returns NULL on bad args / allocation failure.
void* ggrs_net_attach(int fd, int max_batch) {
  if (fd < 0) return nullptr;
  if (max_batch < 1) max_batch = 64;
  if (max_batch > 1024) max_batch = 1024;
  NetBatch* nb = new (std::nothrow) NetBatch();
  if (!nb) return nullptr;
  nb->fd = fd;
  nb->vlen = max_batch;
  size_t v = static_cast<size_t>(max_batch);
  nb->rmsgs.resize(v);
  nb->riov.resize(v);
  nb->raddr.resize(v);
  nb->rbuf.resize(v * kRecvBufSize);
  nb->smsgs.resize(v);
  nb->siov.resize(v);
  nb->saddr.resize(v);
  for (size_t i = 0; i < v; ++i) {
    nb->riov[i].iov_base = nb->rbuf.data() + i * kRecvBufSize;
    nb->riov[i].iov_len = kRecvBufSize;
    std::memset(&nb->rmsgs[i], 0, sizeof(mmsghdr));
    nb->rmsgs[i].msg_hdr.msg_iov = &nb->riov[i];
    nb->rmsgs[i].msg_hdr.msg_iovlen = 1;
    nb->rmsgs[i].msg_hdr.msg_name = &nb->raddr[i];
    nb->rmsgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
  return nb;
}

void ggrs_net_free(void* p) { delete static_cast<NetBatch*>(p); }

// Drain everything available on the fd into the accumulation slab (the
// receive_all_datagrams analog: loop until EAGAIN, but a partial batch
// already proves the queue ran dry at call time, saving the probe call).
// Returns the datagram count, or kNetErrFatal on an unexpected errno.
int ggrs_net_recv_all(void* p) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  nb->rslab.clear();
  nb->rlist.clear();
  while (true) {
    for (int i = 0; i < nb->vlen; ++i) {
      // the kernel shrinks msg_namelen / sets msg_len; reset per call
      nb->rmsgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
      nb->rmsgs[i].msg_len = 0;
    }
    int r = recvmmsg(nb->fd, nb->rmsgs.data(),
                     static_cast<unsigned>(nb->vlen), 0, nullptr);
    nb->st[kStRecvCalls] += 1;
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR || errno == ECONNRESET || errno == ECONNREFUSED) {
        continue;  // the ConnectionResetError-continue of the Python path
      }
      return kNetErrFatal;
    }
    if (r == 0) break;
    nb->st[kStRecvDgrams] += static_cast<uint64_t>(r);
    nb->st[kStRecvHist0 + batch_bucket(r)] += 1;
    for (int i = 0; i < r; ++i) {
      size_t len = nb->rmsgs[i].msg_len;  // > 4096 already truncated
      Dgram d;
      d.ip = nb->raddr[i].sin_addr.s_addr;
      d.port = ntohs(nb->raddr[i].sin_port);
      d.off = static_cast<uint32_t>(nb->rslab.size());
      d.len = static_cast<uint32_t>(len);
      nb->rslab.insert(nb->rslab.end(), nb->rbuf.data() + i * kRecvBufSize,
                       nb->rbuf.data() + i * kRecvBufSize + len);
      nb->rlist.push_back(d);
    }
    if (r < nb->vlen) break;  // queue ran dry mid-batch: no probe needed
  }
  return static_cast<int>(nb->rlist.size());
}

// Datagram count of the last recv_all (the accumulation list survives
// until the next recv_all, so a caller may drain early and route later).
int ggrs_net_recv_count(void* p) {
  return static_cast<int>(static_cast<NetBatch*>(p)->rlist.size());
}

// Accessor for datagram `i` of the last recv_all.  Pointers stay valid
// until the next recv_all on this NetBatch.
int ggrs_net_datagram(void* p, int i, uint32_t* ip, uint16_t* port,
                      const uint8_t** data, uint32_t* len) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  if (i < 0 || static_cast<size_t>(i) >= nb->rlist.size()) {
    return kNetErrBadArgs;
  }
  const Dgram& d = nb->rlist[static_cast<size_t>(i)];
  *ip = d.ip;
  *port = d.port;
  *data = nb->rslab.data() + d.off;
  *len = d.len;
  return kNetOk;
}

// Stage one datagram for the next flush (bytes are copied into the send
// slab; the caller's buffer may be reused immediately).
int ggrs_net_stage(void* p, uint32_t ip, uint16_t port, const uint8_t* data,
                   size_t len) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  if (len > kIdealMaxUdp) nb->st[kStOversized] += 1;
  if (nb->capture) {
    put_u32le(&nb->capture_buf, ip);
    put_u16le(&nb->capture_buf, port);
    put_u32le(&nb->capture_buf, static_cast<uint32_t>(len));
    nb->capture_buf.insert(nb->capture_buf.end(), data, data + len);
  }
  Dgram d;
  d.ip = ip;
  d.port = port;
  d.off = static_cast<uint32_t>(nb->sslab.size());
  d.len = static_cast<uint32_t>(len);
  nb->sslab.insert(nb->sslab.end(), data, data + len);
  nb->slist.push_back(d);
  return kNetOk;
}

// Flush everything staged, in stage order, via sendmmsg windows.  Transient
// errnos drop the failing datagram (counted; the protocol's redundancy
// covers loss) and keep going; a fatal errno abandons the remaining
// datagrams and returns kNetErrFatal — the caller faults the slot, exactly
// like a raising socket.sendto on the Python path.
int ggrs_net_flush(void* p) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  size_t i = 0;
  const size_t n = nb->slist.size();
  int rc_out = kNetOk;
  while (i < n) {
    if (nb->inject_count > 0) {
      // chaos seam: the head datagram "fails" with the injected errno
      // before any syscall (an ENOBUFS/EAGAIN storm, or a fatal EPERM)
      nb->inject_count -= 1;
      if (transient_send_errno(nb->inject_errno)) {
        nb->st[kStSendErrors] += 1;
        i += 1;
        continue;
      }
      rc_out = kNetErrFatal;
      break;
    }
    size_t win = n - i;
    if (win > static_cast<size_t>(nb->vlen)) win = nb->vlen;
    for (size_t k = 0; k < win; ++k) {
      const Dgram& d = nb->slist[i + k];
      nb->siov[k].iov_base = nb->sslab.data() + d.off;
      nb->siov[k].iov_len = d.len;
      std::memset(&nb->saddr[k], 0, sizeof(sockaddr_in));
      nb->saddr[k].sin_family = AF_INET;
      nb->saddr[k].sin_addr.s_addr = d.ip;
      nb->saddr[k].sin_port = htons(d.port);
      std::memset(&nb->smsgs[k], 0, sizeof(mmsghdr));
      nb->smsgs[k].msg_hdr.msg_iov = &nb->siov[k];
      nb->smsgs[k].msg_hdr.msg_iovlen = 1;
      nb->smsgs[k].msg_hdr.msg_name = &nb->saddr[k];
      nb->smsgs[k].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    int r = sendmmsg(nb->fd, nb->smsgs.data(), static_cast<unsigned>(win), 0);
    nb->st[kStSendCalls] += 1;
    if (r < 0) {
      if (errno == EINTR) continue;  // retry the same window: PEP 475
      // semantics — a signal mid-send is invisible on the Python path
      // the errno belongs to the FIRST datagram of the window
      if (transient_send_errno(errno)) {
        nb->st[kStSendErrors] += 1;
        i += 1;
        continue;
      }
      rc_out = kNetErrFatal;
      break;
    }
    nb->st[kStSendDgrams] += static_cast<uint64_t>(r);
    nb->st[kStSendHist0 + batch_bucket(r)] += 1;
    i += static_cast<size_t>(r);
    // r < win without an errno: the next loop iteration retries from the
    // stall point and surfaces the real errno if one is pending
  }
  nb->slist.clear();
  nb->sslab.clear();
  return rc_out;
}

int64_t ggrs_net_staged_len(void* p) {
  return static_cast<int64_t>(static_cast<NetBatch*>(p)->slist.size());
}

void ggrs_net_stats(void* p, uint64_t* out) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  std::memcpy(out, nb->st, sizeof(nb->st));
}

// ---- test seams ---------------------------------------------------------

void ggrs_net_set_capture(void* p, int on) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  nb->capture = on != 0;
  if (!nb->capture) nb->capture_buf.clear();
}

// Drain the capture tee: [u32 ip][u16 port][u32 len][bytes] per datagram,
// in stage (= send) order.  kNetErrBufferTooSmall reports the needed size
// without consuming.
int ggrs_net_drain_capture(void* p, uint8_t* out, size_t cap,
                           size_t* out_len) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  *out_len = nb->capture_buf.size();
  if (nb->capture_buf.size() > cap) return kNetErrBufferTooSmall;
  std::memcpy(out, nb->capture_buf.data(), nb->capture_buf.size());
  nb->capture_buf.clear();
  return kNetOk;
}

// The next `count` staged datagrams fail with `err` before any syscall.
void ggrs_net_inject_send_errno(void* p, int err, int count) {
  NetBatch* nb = static_cast<NetBatch*>(p);
  nb->inject_errno = err;
  nb->inject_count = count;
}

// GSO capability + override (gen 2).  ggrs_net_gso_supported() is the
// cached per-kernel probe; ggrs_net_set_gso(-1/0/1) is the caller
// override (auto / forced off / forced on — forcing on still requires
// the probe, a kernel that refuses UDP_SEGMENT cannot be forced).
int ggrs_net_gso_supported(void) { return gso_probe(); }
void ggrs_net_set_gso(int mode) {
  g_gso_mode = mode < 0 ? -1 : (mode ? 1 : 0);
}

// GRO capability + override (gen 2, §23d) — the receive-side siblings.
// A kernel that refuses UDP_GRO cannot be forced on; forcing off pins the
// drain to the pre-GRO record walk bit-identically (the 4096-byte ring,
// no cmsg parse).
int ggrs_net_gro_supported(void) { return gro_probe(); }
void ggrs_net_set_gro(int mode) {
  g_gro_mode = mode < 0 ? -1 : (mode ? 1 : 0);
}

// Chaos seam for the table path (the NetBatch inject covers only
// attached sockets): record indices >= `at` of subsequent
// ggrs_net_send_table calls fail with `err` before any syscall, one
// record per count, until `count` is exhausted.
void ggrs_net_inject_table_errno(int err, int64_t at, int count) {
  g_table_inject_errno = err;
  g_table_inject_at = at < 0 ? 0 : at;
  g_table_inject_count = count;
}

// One-shot batched send over ARBITRARY fds (descriptor plane, §21; gen 2
// §23): no NetBatch attach, no rings kept — the Python pool hands the
// whole tick's non-attached outbound as one packed table (`desc`: n
// records of kSendStride bytes; `payload`: the buffer the off/len fields
// index, usually the tick output buffer itself, zero copies).
// Consecutive same-fd records group into sendmmsg windows, so a pool
// tick pays one Python→C crossing total and ~one syscall per socket
// instead of one of each per datagram.  Gen 2: consecutive same-(ip,port)
// equal-size records inside a window coalesce into ONE UDP_SEGMENT
// (GSO) message when the kernel supports it — the spectator fan-out's
// per-viewer catch-up bursts become one segmented send — with automatic
// per-group fallback to plain sendmmsg on any GSO send failure.
//
// Errno semantics mirror UdpNonBlockingSocket.send_datagram exactly:
// transient errnos count the datagram as lost (stats[1]) and the flush
// continues; a fatal errno is reported as a (record index, errno) pair
// in `fatal` so the caller can fault exactly the owning slot.  A fatal
// on a plain per-slot record abandons the REST OF THAT FD's run (the
// same partial-send window a raising sendto leaves); a fatal on a
// record carrying kSendFlagDispatch (offset 10, bit0) skips ONLY that
// record — the fd is shared by many slots, and co-tenant records must
// still flush (§9: fault the owning slot, never the pool).  Oversized
// datagrams are counted (stats[2]), never blocked.  stats =
// {sent, transient_errors, oversized, gso_sends, gso_segments}
// (kSendTableStats words, accumulated; callers zero it).
//
// Returns the number of fatal pairs written (0 = clean), or
// kNetErrBadArgs.  The caller must sort records so each fd forms one
// contiguous run; a fatal fd seen again in a LATER run is retried (the
// pool never emits split runs).
int ggrs_net_send_table(const uint8_t* desc, int64_t n,
                        const uint8_t* payload, size_t payload_len,
                        uint64_t* stats, int32_t* fatal, int fatal_cap) {
  if (n < 0 || (n > 0 && (!desc || !payload || !stats))) {
    return kNetErrBadArgs;
  }
  constexpr int kWin = 64;
  constexpr int kGsoMaxSegs = 60;       // < UDP_MAX_SEGMENTS (64)
  constexpr size_t kGsoMaxBytes = 60000;  // < 16-bit UDP length budget
  static thread_local std::vector<mmsghdr> msgs(kWin);
  static thread_local std::vector<iovec> iov(kWin * kGsoMaxSegs);
  static thread_local std::vector<sockaddr_in> addr(kWin);
  static thread_local std::vector<uint8_t> cmsg(
      kWin * CMSG_SPACE(sizeof(uint16_t)));
  static thread_local std::vector<int64_t> msg_rec0(kWin);
  static thread_local std::vector<int64_t> msg_nrec(kWin);
  int n_fatal = 0;
  int64_t i = 0;
  // per-call GSO retreat: any send failure whose window head is a GSO
  // group falls the whole group back to plain records (covers both
  // transient parity — drop ONE datagram, not the group — and kernels
  // that accept the setsockopt probe but refuse segmented sends)
  int64_t plain_until = -1;
  auto rec = [&](int64_t k, int32_t* fd, uint32_t* ip, uint16_t* port,
                 uint16_t* flags, uint32_t* off, uint32_t* len) {
    const uint8_t* p = desc + static_cast<size_t>(k) * kSendStride;
    auto r32 = [&p](size_t at) {
      uint32_t v = 0;
      for (int b = 0; b < 4; ++b) {
        v |= static_cast<uint32_t>(p[at + b]) << (8 * b);
      }
      return v;
    };
    *fd = static_cast<int32_t>(r32(0));
    *ip = r32(4);
    *port = static_cast<uint16_t>(p[8] | (p[9] << 8));
    *flags = static_cast<uint16_t>(p[10] | (p[11] << 8));
    *off = r32(12);
    *len = r32(16);
  };
  auto inject_hits = [&](int64_t k) {
    return g_table_inject_count > 0 && k >= g_table_inject_at;
  };
  while (i < n) {
    int32_t fd;
    uint32_t ip, off, len;
    uint16_t port, flags;
    rec(i, &fd, &ip, &port, &flags, &off, &len);
    // the fd's contiguous run [i, run_end)
    int64_t run_end = i;
    while (run_end < n) {
      int32_t fd2;
      uint32_t ip2, off2, len2;
      uint16_t port2, flags2;
      rec(run_end, &fd2, &ip2, &port2, &flags2, &off2, &len2);
      if (fd2 != fd) break;
      if (static_cast<size_t>(off2) + len2 > payload_len) {
        return kNetErrBadArgs;  // corrupt table: refuse whole call
      }
      if (len2 > kIdealMaxUdp) stats[2] += 1;
      ++run_end;
    }
    int64_t j = i;
    while (j < run_end) {
      // chaos seam: the head record "fails" with the injected errno
      // before any syscall (window building below guarantees an
      // injected record always surfaces as a window head)
      if (inject_hits(j)) {
        g_table_inject_count -= 1;
        int32_t fdj;
        uint32_t ipj, offj, lenj;
        uint16_t portj, flagsj;
        rec(j, &fdj, &ipj, &portj, &flagsj, &offj, &lenj);
        if (transient_send_errno(g_table_inject_errno)) {
          stats[1] += 1;
          j += 1;
          continue;
        }
        if (n_fatal < fatal_cap && fatal) {
          fatal[2 * n_fatal] = static_cast<int32_t>(j);
          fatal[2 * n_fatal + 1] = static_cast<int32_t>(g_table_inject_errno);
        }
        ++n_fatal;
        if (flagsj & kSendFlagDispatch) {
          j += 1;  // shared fd: co-tenant records keep flushing
          continue;
        }
        break;  // per-slot fd: abandon the rest of the run
      }
      // build one sendmmsg window of up to kWin messages; each message
      // is either a single record or a GSO group of >= 2 consecutive
      // same-destination records (all full segments except a shorter
      // tail), expressed as one multi-iovec message + UDP_SEGMENT cmsg
      size_t nmsg = 0;
      size_t iov_used = 0;
      int64_t cursor = j;
      const bool gso = gso_active();
      while (nmsg < static_cast<size_t>(kWin) && cursor < run_end) {
        if (cursor > j && inject_hits(cursor)) break;  // keep at head
        int32_t fd0;
        uint32_t ip0, off0, len0;
        uint16_t port0, flags0;
        rec(cursor, &fd0, &ip0, &port0, &flags0, &off0, &len0);
        int64_t g = 1;
        if (gso && cursor >= plain_until && len0 > 0) {
          size_t total = len0;
          while (cursor + g < run_end && g < kGsoMaxSegs) {
            if (inject_hits(cursor + g)) break;
            int32_t fdg;
            uint32_t ipg, offg, leng;
            uint16_t portg, flagsg;
            rec(cursor + g - 1, &fdg, &ipg, &portg, &flagsg, &offg, &leng);
            if (leng != len0) break;  // previous must be a full segment
            rec(cursor + g, &fdg, &ipg, &portg, &flagsg, &offg, &leng);
            if (ipg != ip0 || portg != port0) break;
            if (leng > len0 || total + leng > kGsoMaxBytes) break;
            total += leng;
            ++g;
          }
        }
        if (g >= 2 && iov_used + static_cast<size_t>(g) > iov.size()) {
          break;  // iovec pool exhausted: flush what we have first
        }
        std::memset(&addr[nmsg], 0, sizeof(sockaddr_in));
        addr[nmsg].sin_family = AF_INET;
        addr[nmsg].sin_addr.s_addr = ip0;
        addr[nmsg].sin_port = htons(port0);
        std::memset(&msgs[nmsg], 0, sizeof(mmsghdr));
        msgs[nmsg].msg_hdr.msg_name = &addr[nmsg];
        msgs[nmsg].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        msgs[nmsg].msg_hdr.msg_iov = &iov[iov_used];
        msgs[nmsg].msg_hdr.msg_iovlen = static_cast<size_t>(g);
        for (int64_t s = 0; s < g; ++s) {
          int32_t fds_;
          uint32_t ips, offs, lens;
          uint16_t ports, flagss;
          rec(cursor + s, &fds_, &ips, &ports, &flagss, &offs, &lens);
          iov[iov_used + static_cast<size_t>(s)].iov_base =
              const_cast<uint8_t*>(payload) + offs;
          iov[iov_used + static_cast<size_t>(s)].iov_len = lens;
        }
        if (g >= 2) {
          uint8_t* cb = cmsg.data() + nmsg * CMSG_SPACE(sizeof(uint16_t));
          msgs[nmsg].msg_hdr.msg_control = cb;
          msgs[nmsg].msg_hdr.msg_controllen = CMSG_SPACE(sizeof(uint16_t));
          cmsghdr* cm = CMSG_FIRSTHDR(&msgs[nmsg].msg_hdr);
          cm->cmsg_level = SOL_UDP;
          cm->cmsg_type = UDP_SEGMENT;
          cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
          uint16_t seg = static_cast<uint16_t>(len0);
          std::memcpy(CMSG_DATA(cm), &seg, sizeof(seg));
        }
        msg_rec0[nmsg] = cursor;
        msg_nrec[nmsg] = g;
        iov_used += static_cast<size_t>(g);
        cursor += g;
        ++nmsg;
      }
      if (nmsg == 0) break;  // defensive: cannot make progress
      int r = sendmmsg(fd, msgs.data(), static_cast<unsigned>(nmsg), 0);
      if (r < 0) {
        if (errno == EINTR) continue;  // PEP 475: retry the window
        if (msg_nrec[0] > 1) {
          // GSO head failed: retreat the whole group to plain records
          // and retry, so the errno attributes to exactly one datagram
          plain_until = msg_rec0[0] + msg_nrec[0];
          continue;
        }
        if (transient_send_errno(errno)) {
          stats[1] += 1;  // the head datagram is lost; keep going
          j += 1;
          continue;
        }
        int32_t fdj;
        uint32_t ipj, offj, lenj;
        uint16_t portj, flagsj;
        rec(j, &fdj, &ipj, &portj, &flagsj, &offj, &lenj);
        if (n_fatal < fatal_cap && fatal) {
          fatal[2 * n_fatal] = static_cast<int32_t>(j);
          fatal[2 * n_fatal + 1] = static_cast<int32_t>(errno);
        }
        ++n_fatal;
        if (flagsj & kSendFlagDispatch) {
          j += 1;  // shared fd: co-tenant records keep flushing
          continue;
        }
        break;  // per-slot fd: abandon the rest of the run
      }
      int64_t sent_recs = 0;
      for (int k = 0; k < r; ++k) {
        sent_recs += msg_nrec[static_cast<size_t>(k)];
        if (msg_nrec[static_cast<size_t>(k)] > 1) {
          stats[3] += 1;
          stats[4] += static_cast<uint64_t>(msg_nrec[static_cast<size_t>(k)]);
        }
      }
      stats[0] += static_cast<uint64_t>(sent_recs);
      j += sent_recs;
      // r < nmsg without errno: retry from the stall point next iteration
    }
    i = run_end;
  }
  return n_fatal;
}

// One-crossing inbound drain over ARBITRARY fds (gen 2, §23): the pool
// hands its whole non-attached fd set as one packed table (`fds`: n_fds
// entries of kFdStride bytes — i32 fd, i32 slot; slot == -1 marks a
// shared DISPATCH fd) plus a route table sorted by (ip, port)
// (`routes`: n_routes entries of kRouteStride bytes) for demuxing
// dispatch datagrams by source address.  Every fd is drained
// recvmmsg-until-dry with ggrs_net_recv_all's errno semantics; each
// datagram is copied once into `slab` and described by one kRecvStride
// record in `recs` (i32 slot, i32 fd_idx, u32 ip, u16 port, u16 pad,
// u32 off, u32 len), in arrival order per fd — the exact order the
// per-slot receive_all_datagrams reference observes.
//
// A fatal recv errno is reported as a (fd index, errno) pair in `fatal`
// (that fd stops; others keep draining) so the caller faults exactly
// the owning slot(s).  Unroutable dispatch datagrams are dropped and
// counted (stats[2]), like the Python demux dropping unknown sources.
// When the record table or slab cannot hold another full batch the
// drain STOPS — never mid-batch, so nothing read from the kernel is
// lost — and counts a backpressure stop (stats[3]); the kernel queue
// keeps the rest for the caller to regrow and re-drain.  stats =
// {recv_calls, datagrams, unroutable, backpressure_stops, hist[8],
// gro_datagrams, gro_segments} (kRecvTableStats words, accumulated;
// callers zero it).
//
// GRO (§23d): when the kernel takes UDP_GRO (and the caller enabled it
// on the fds — DispatchHub does), the drain runs on a wide ring (64 KiB
// buffers + cmsg space), reads the UDP_GRO cmsg per message, and splits
// each coalesced train back into one record per WIRE datagram: seg index
// at record offset 14, stats[1] counting segments so the datagram count
// matches the GRO-off drain exactly.  Ordinary datagrams on the wide
// ring clamp to the reference ring's 4096-byte truncation, so GRO-on is
// bit-identical to GRO-off on everything the records describe; the
// backpressure clamp reserves the kernel's 64-segments-per-train worst
// case before every syscall, same never-lose-what-was-read rule.
//
// Returns the record count (>= 0) or kNetErrBadArgs; the fatal-pair
// count lands in *n_fatal_out.
int ggrs_net_recv_table(const uint8_t* fds, int n_fds,
                        const uint8_t* routes, int n_routes,
                        uint8_t* recs, int max_recs,
                        uint8_t* slab, int64_t slab_cap,
                        uint64_t* stats, int32_t* fatal, int fatal_cap,
                        int32_t* n_fatal_out) {
  if (n_fds < 0 || n_routes < 0 || max_recs < 0 || slab_cap < 0 ||
      (n_fds > 0 && (!fds || !recs || !slab || !stats || !n_fatal_out)) ||
      (n_routes > 0 && !routes)) {
    return kNetErrBadArgs;
  }
  constexpr int kDrainWin = 64;
  struct Ring {
    std::vector<mmsghdr> msgs;
    std::vector<iovec> iov;
    std::vector<sockaddr_in> addr;
    std::vector<uint8_t> buf;
    Ring() : msgs(kDrainWin), iov(kDrainWin), addr(kDrainWin),
             buf(static_cast<size_t>(kDrainWin) * kRecvBufSize) {
      for (int k = 0; k < kDrainWin; ++k) {
        iov[k].iov_base = buf.data() + static_cast<size_t>(k) * kRecvBufSize;
        iov[k].iov_len = kRecvBufSize;
        std::memset(&msgs[k], 0, sizeof(mmsghdr));
        msgs[k].msg_hdr.msg_iov = &iov[k];
        msgs[k].msg_hdr.msg_iovlen = 1;
        msgs[k].msg_hdr.msg_name = &addr[k];
        msgs[k].msg_hdr.msg_namelen = sizeof(sockaddr_in);
      }
    }
  };
  // GRO ring (§23d): 64 KiB messages — one coalesced train can be a full
  // UDP payload — plus per-message cmsg space for the UDP_GRO
  // segment-size ancillary data.  The window matches the normal ring's
  // (kDrainWin): when the kernel coalesces nothing (small sparse flows)
  // an armed drain must not batch WORSE than the 4 KiB ring, and when it
  // does coalesce, 64 msgs × up to 64 segments pulls ~4k wire datagrams
  // per syscall.  Lazily constructed thread-local: a GRO-less box never
  // pays the ~4 MiB.
  constexpr int kGroWin = 64;
  constexpr size_t kGroBufSize = 65536;
  constexpr int kGroMaxSegs = 64;   // kernel cap on segments per train
  constexpr size_t kGroCtlSpace = 64;  // >= CMSG_SPACE(sizeof(int)) + slack
  struct GroRing {
    std::vector<mmsghdr> msgs;
    std::vector<iovec> iov;
    std::vector<sockaddr_in> addr;
    std::vector<uint8_t> buf;
    std::vector<uint8_t> ctl;
    GroRing() : msgs(kGroWin), iov(kGroWin), addr(kGroWin),
                buf(static_cast<size_t>(kGroWin) * kGroBufSize),
                ctl(static_cast<size_t>(kGroWin) * kGroCtlSpace) {
      for (int k = 0; k < kGroWin; ++k) {
        iov[k].iov_base = buf.data() + static_cast<size_t>(k) * kGroBufSize;
        iov[k].iov_len = kGroBufSize;
        std::memset(&msgs[k], 0, sizeof(mmsghdr));
        msgs[k].msg_hdr.msg_iov = &iov[k];
        msgs[k].msg_hdr.msg_iovlen = 1;
        msgs[k].msg_hdr.msg_name = &addr[k];
        msgs[k].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        msgs[k].msg_hdr.msg_control =
            ctl.data() + static_cast<size_t>(k) * kGroCtlSpace;
        msgs[k].msg_hdr.msg_controllen = kGroCtlSpace;
      }
    }
  };
  const bool gro = gro_active();
  mmsghdr* msgs;
  sockaddr_in* addr_ring;
  uint8_t* bufp;
  int win;
  size_t bufsz;
  if (gro) {
    static thread_local GroRing gring;
    msgs = gring.msgs.data();
    addr_ring = gring.addr.data();
    bufp = gring.buf.data();
    win = kGroWin;
    bufsz = kGroBufSize;
  } else {
    static thread_local Ring ring;
    msgs = ring.msgs.data();
    addr_ring = ring.addr.data();
    bufp = ring.buf.data();
    win = kDrainWin;
    bufsz = kRecvBufSize;
  }
  int n_recs = 0;
  int64_t slab_used = 0;
  int n_fatal = 0;
  bool full = false;
  auto emit_rec = [&](int32_t dst, int fd_idx, uint32_t ip, uint16_t port,
                      uint16_t seg, const uint8_t* src, size_t len) {
    uint8_t* rp = recs + static_cast<size_t>(n_recs) * kRecvStride;
    auto w32 = [&rp](size_t at, uint32_t v) {
      for (int b = 0; b < 4; ++b) rp[at + b] = (v >> (8 * b)) & 0xFF;
    };
    w32(0, static_cast<uint32_t>(dst));
    w32(4, static_cast<uint32_t>(fd_idx));
    w32(8, ip);
    rp[12] = port & 0xFF;
    rp[13] = port >> 8;
    rp[14] = seg & 0xFF;
    rp[15] = seg >> 8;
    w32(16, static_cast<uint32_t>(slab_used));
    w32(20, static_cast<uint32_t>(len));
    std::memcpy(slab + slab_used, src, len);
    slab_used += static_cast<int64_t>(len);
    ++n_recs;
    stats[1] += 1;
  };
  for (int e = 0; e < n_fds && !full; ++e) {
    const uint8_t* fp = fds + static_cast<size_t>(e) * kFdStride;
    int32_t fd = 0, slot = 0;
    for (int b = 0; b < 4; ++b) {
      fd |= static_cast<int32_t>(fp[b]) << (8 * b);
      slot |= static_cast<int32_t>(fp[4 + b]) << (8 * b);
    }
    while (true) {
      // clamp the batch so every datagram the kernel hands over has a
      // guaranteed record + slab home — backpressure stops BEFORE the
      // syscall, never after, so no datagram is silently dropped.  Under
      // GRO each message can explode into up to kGroMaxSegs records and a
      // full 64 KiB of slab, so the reservation divides by that worst
      // case; the Python regrow loop absorbs the conservatism.
      int vlen = win;
      int rec_room = (max_recs - n_recs) / (gro ? kGroMaxSegs : 1);
      if (vlen > rec_room) vlen = rec_room;
      int64_t slab_room =
          (slab_cap - slab_used) / static_cast<int64_t>(bufsz);
      if (vlen > slab_room) vlen = static_cast<int>(slab_room);
      if (vlen <= 0) {
        stats[3] += 1;
        full = true;
        break;
      }
      for (int k = 0; k < vlen; ++k) {
        msgs[k].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        msgs[k].msg_len = 0;
        if (gro) {
          msgs[k].msg_hdr.msg_controllen = kGroCtlSpace;
          msgs[k].msg_hdr.msg_flags = 0;
        }
      }
      int r = recvmmsg(fd, msgs, static_cast<unsigned>(vlen), 0, nullptr);
      stats[0] += 1;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR || errno == ECONNRESET || errno == ECONNREFUSED) {
          continue;  // the ConnectionResetError-continue of the Python path
        }
        if (n_fatal < fatal_cap && fatal) {
          fatal[2 * n_fatal] = e;
          fatal[2 * n_fatal + 1] = static_cast<int32_t>(errno);
        }
        ++n_fatal;
        break;  // this fd stops; the others keep draining
      }
      if (r == 0) break;
      stats[4 + batch_bucket(r)] += 1;
      for (int k = 0; k < r; ++k) {
        uint32_t ip = addr_ring[k].sin_addr.s_addr;
        uint16_t port = ntohs(addr_ring[k].sin_port);
        int32_t dst = slot;
        if (dst < 0) {
          dst = route_lookup(routes, n_routes, ip, port);
          if (dst < 0) {
            stats[2] += 1;  // unroutable dispatch source: drop, like the
            continue;       // Python demux ignoring unknown senders
          }
        }
        size_t len = msgs[k].msg_len;
        const uint8_t* src = bufp + static_cast<size_t>(k) * bufsz;
        size_t gso_size = 0;
        if (gro) {
          for (cmsghdr* cm = CMSG_FIRSTHDR(&msgs[k].msg_hdr); cm;
               cm = CMSG_NXTHDR(&msgs[k].msg_hdr, cm)) {
            if (cm->cmsg_level == SOL_UDP && cm->cmsg_type == UDP_GRO) {
              int gs = 0;
              std::memcpy(&gs, CMSG_DATA(cm), sizeof(gs));
              if (gs > 0) gso_size = static_cast<size_t>(gs);
              break;
            }
          }
        }
        if (gso_size > 0 && len > gso_size) {
          // coalesced train: split back into wire datagrams so the
          // record walk sees exactly what GRO-off would have seen,
          // tagging each record with its segment index
          stats[kStGroDgrams] += 1;
          uint16_t seg = 0;
          size_t off = 0;
          while (off < len) {
            size_t part = len - off;
            if (part > gso_size) part = gso_size;
            // defensive fold: the pre-syscall reserve guarantees
            // kGroMaxSegs records per message, so running out here
            // means a >64-segment train — fold the remainder into the
            // final record rather than drop bytes
            if (n_recs + 1 >= max_recs || seg == kGroMaxSegs - 1) {
              part = len - off;
            }
            emit_rec(dst, e, ip, port, seg, src + off, part);
            stats[kStGroSegs] += 1;
            off += part;
            ++seg;
          }
        } else {
          // ordinary datagram: on the wide GRO ring, clamp to the
          // reference ring's buffer size so an oversized datagram
          // truncates exactly as it does with GRO off (parity)
          if (gro && len > kRecvBufSize) len = kRecvBufSize;
          emit_rec(dst, e, ip, port, 0, src, len);
        }
      }
      if (r < vlen) break;  // queue ran dry mid-batch: no probe needed
    }
  }
  if (n_fatal_out) *n_fatal_out = n_fatal;
  return n_recs;
}

}  // extern "C"

#else  // !__linux__ -------------------------------------------------------

// Stub surface: same symbols, no batched path.  ggrs_net_supported() == 0
// keeps the pool on the Python shuttle (the documented fallback), and the
// bank never sees an attached socket.

extern "C" {

int ggrs_net_supported(void) { return 0; }
void* ggrs_net_attach(int, int) { return nullptr; }
void ggrs_net_free(void*) {}
int ggrs_net_recv_all(void*) { return kNetErrUnsupported; }
int ggrs_net_recv_count(void*) { return 0; }
int ggrs_net_datagram(void*, int, uint32_t*, uint16_t*, const uint8_t**,
                      uint32_t*) {
  return kNetErrUnsupported;
}
int ggrs_net_stage(void*, uint32_t, uint16_t, const uint8_t*, size_t) {
  return kNetErrUnsupported;
}
int ggrs_net_flush(void*) { return kNetErrUnsupported; }
int64_t ggrs_net_staged_len(void*) { return 0; }
void ggrs_net_stats(void*, uint64_t* out) {
  std::memset(out, 0, sizeof(uint64_t) * kNumNetStats);
}
void ggrs_net_set_capture(void*, int) {}
int ggrs_net_drain_capture(void*, uint8_t*, size_t, size_t* out_len) {
  *out_len = 0;
  return kNetErrUnsupported;
}
void ggrs_net_inject_send_errno(void*, int, int) {}
int ggrs_net_send_table(const uint8_t*, int64_t, const uint8_t*, size_t,
                        uint64_t*, int32_t*, int) {
  return kNetErrUnsupported;
}
int ggrs_net_recv_table(const uint8_t*, int, const uint8_t*, int, uint8_t*,
                        int, uint8_t*, int64_t, uint64_t*, int32_t*, int,
                        int32_t* n_fatal_out) {
  if (n_fatal_out) *n_fatal_out = 0;
  return kNetErrUnsupported;
}
int ggrs_net_gso_supported(void) { return 0; }
void ggrs_net_set_gso(int) {}
int ggrs_net_gro_supported(void) { return 0; }
void ggrs_net_set_gro(int) {}
void ggrs_net_inject_table_errno(int, int64_t, int) {}

}  // extern "C"

#endif  // __linux__
