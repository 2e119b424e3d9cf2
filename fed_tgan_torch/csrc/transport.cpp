// fed_tgan_torch host transport: length-prefixed TCP message passing
// (a copy of the JAX package's native transport, built by the port at first
// use into fed_tgan_torch/_build/).
//
// The role PyTorch RPC over Gloo/TensorPipe plays in the reference
// (Server/dtds/distributed.py:849-857): a rendezvous of one server (rank 0)
// and N clients over TCP, exchanging opaque byte payloads (the Python layer
// pickles).
//
// Design notes:
// - The per-round aggregation runs over torch.distributed collectives; this
//   transport carries only the cold, object-valued init phase (metadata,
//   encoders, mixture models) and control messages (rank 1's round reports
//   and snapshots, every participant's final parameters), so simplicity and
//   robustness beat throughput tricks.
// - Frames: 8-byte little-endian payload length, then payload.
// - All calls are blocking with an optional deadline; errors are negative
//   return codes (never exceptions across the C ABI).

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <vector>

namespace {

constexpr int kErrSocket = -1;
constexpr int kErrTimeout = -2;
constexpr int kErrClosed = -3;
constexpr int kErrArg = -4;

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Block until fd is ready for events or deadline passes.
int wait_fd(int fd, short events, int64_t deadline_ms) {
  while (true) {
    int64_t budget = deadline_ms < 0 ? -1 : deadline_ms - now_ms();
    if (deadline_ms >= 0 && budget <= 0) return kErrTimeout;
    struct pollfd p = {fd, events, 0};
    int rc = poll(&p, 1, deadline_ms < 0 ? -1 : static_cast<int>(budget));
    if (rc > 0) return 0;
    if (rc == 0) return kErrTimeout;
    if (errno != EINTR) return kErrSocket;
  }
}

int send_all(int fd, const uint8_t* buf, size_t len, int64_t deadline_ms) {
  size_t off = 0;
  while (off < len) {
    int rc = wait_fd(fd, POLLOUT, deadline_ms);
    if (rc < 0) return rc;
    ssize_t n = ::send(fd, buf + off, len - off, MSG_NOSIGNAL);
    if (n > 0) {
      off += static_cast<size_t>(n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)) {
      continue;
    } else {
      return kErrClosed;
    }
  }
  return 0;
}

int recv_all(int fd, uint8_t* buf, size_t len, int64_t deadline_ms) {
  size_t off = 0;
  while (off < len) {
    int rc = wait_fd(fd, POLLIN, deadline_ms);
    if (rc < 0) return rc;
    ssize_t n = ::recv(fd, buf + off, len - off, 0);
    if (n > 0) {
      off += static_cast<size_t>(n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)) {
      continue;
    } else {
      return kErrClosed;
    }
  }
  return 0;
}

void set_common_opts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // non-blocking + poll gives us deadlines everywhere
  // (fcntl O_NONBLOCK)
  int flags = 0;
  flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

struct Endpoint {
  std::vector<int> peers;  // server: fd per client rank; client: single fd
  int listen_fd = -1;
  bool is_server = false;
};

}  // namespace

extern "C" {

// errno of the most recent failed create on this thread, for diagnostics
// (a bare null handle told callers nothing about WHY the bind failed)
static thread_local int g_last_errno = 0;

int ft_last_errno() { return g_last_errno; }

// ---- server ----------------------------------------------------------------

// Create a listening endpoint on port; returns handle (>0 pointer) or null.
void* ft_server_create(int port) {
  g_last_errno = 0;  // never report a stale, unrelated failure
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    g_last_errno = errno;
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    g_last_errno = errno;
    close(fd);
    return nullptr;
  }
  auto* ep = new Endpoint();
  ep->listen_fd = fd;
  ep->is_server = true;
  return ep;
}

// Accept n clients; each must send a 4-byte rank (1..n) right after connect.
// Returns 0 or a negative error.
int ft_server_accept(void* handle, int n_clients, int timeout_ms) {
  auto* ep = static_cast<Endpoint*>(handle);
  if (!ep || !ep->is_server || n_clients <= 0) return kErrArg;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  ep->peers.assign(static_cast<size_t>(n_clients), -1);
  int connected = 0;
  set_common_opts(ep->listen_fd);
  while (connected < n_clients) {
    int rc = wait_fd(ep->listen_fd, POLLIN, deadline);
    if (rc < 0) return rc;
    int cfd = accept(ep->listen_fd, nullptr, nullptr);
    if (cfd < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) continue;
      return kErrSocket;
    }
    set_common_opts(cfd);
    uint32_t rank_le = 0;
    rc = recv_all(cfd, reinterpret_cast<uint8_t*>(&rank_le), 4, deadline);
    if (rc < 0) {
      close(cfd);
      return rc;
    }
    uint32_t rank = le32toh(rank_le);
    if (rank < 1 || rank > static_cast<uint32_t>(n_clients) ||
        ep->peers[rank - 1] != -1) {
      close(cfd);
      return kErrArg;  // duplicate or out-of-range rank
    }
    ep->peers[rank - 1] = cfd;
    ++connected;
  }
  return 0;
}

// Accept ONE (re)connecting client if a connection lands within timeout_ms.
// The client announces its 4-byte rank exactly like the initial rendezvous;
// any existing fd for that rank is closed and replaced, so a client that
// lost its connection can rejoin mid-protocol.  Returns the rank (>= 1),
// 0 if nothing arrived before the deadline, or a negative error.
int ft_server_poll_accept(void* handle, int timeout_ms) {
  auto* ep = static_cast<Endpoint*>(handle);
  if (!ep || !ep->is_server || ep->peers.empty()) return kErrArg;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  int rc = wait_fd(ep->listen_fd, POLLIN, deadline);
  if (rc == kErrTimeout) return 0;
  if (rc < 0) return rc;
  int cfd = accept(ep->listen_fd, nullptr, nullptr);
  if (cfd < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return 0;
    return kErrSocket;
  }
  set_common_opts(cfd);
  uint32_t rank_le = 0;
  // the rank announcement is 4 bytes from an already-connected peer; give
  // it a short fixed budget so a half-open connection can't wedge us
  rc = recv_all(cfd, reinterpret_cast<uint8_t*>(&rank_le), 4,
                now_ms() + 5000);
  if (rc < 0) {
    close(cfd);
    return rc;
  }
  uint32_t rank = le32toh(rank_le);
  if (rank < 1 || rank > ep->peers.size()) {
    close(cfd);
    return kErrArg;
  }
  if (ep->peers[rank - 1] >= 0) close(ep->peers[rank - 1]);
  ep->peers[rank - 1] = cfd;
  return static_cast<int>(rank);
}

// Close the connection to one peer (server: 1-based rank; client: 0) while
// keeping the endpoint alive — marks a dropped client, and lets the
// fault-injection harness sever a live connection to exercise reconnect.
int ft_peer_close(void* handle, int peer) {
  auto* ep = static_cast<Endpoint*>(handle);
  if (!ep) return kErrArg;
  size_t idx;
  if (ep->is_server) {
    if (peer < 1 || static_cast<size_t>(peer) > ep->peers.size())
      return kErrArg;
    idx = static_cast<size_t>(peer - 1);
  } else {
    if (ep->peers.empty()) return kErrArg;
    idx = 0;
  }
  if (ep->peers[idx] >= 0) {
    close(ep->peers[idx]);
    ep->peers[idx] = -1;
  }
  return 0;
}

// ---- client ----------------------------------------------------------------

// Connect to host:port and announce rank (1-based); retries until deadline
// so client and server start order doesn't matter (the reference's
// rendezvous behavior).
void* ft_client_create(const char* host, int port, int rank, int timeout_ms) {
  g_last_errno = 0;  // never report a stale, unrelated failure
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    g_last_errno = EINVAL;  // host is not a numeric IPv4 address
    return nullptr;
  }

  while (true) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      g_last_errno = errno;
      return nullptr;
    }
    set_common_opts(fd);  // O_NONBLOCK first so connect honors the deadline
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    bool ok = rc == 0;
    if (!ok && errno == EINPROGRESS) {
      if (wait_fd(fd, POLLOUT, deadline) == 0) {
        int err = 0;
        socklen_t len = sizeof(err);
        ok = getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) == 0 && err == 0;
        if (!ok && err) errno = err;  // surface the real connect failure
      }
    }
    if (ok) {
      uint32_t rank_le = htole32(static_cast<uint32_t>(rank));
      if (send_all(fd, reinterpret_cast<uint8_t*>(&rank_le), 4, deadline) != 0) {
        g_last_errno = errno ? errno : EPIPE;
        close(fd);
        return nullptr;
      }
      auto* ep = new Endpoint();
      ep->peers.push_back(fd);
      return ep;
    }
    int connect_errno = errno;
    close(fd);
    if (deadline >= 0 && now_ms() >= deadline) {
      // EINPROGRESS means the final nonblocking connect was still pending
      // when the rendezvous deadline hit — report the timeout, not it
      g_last_errno = (connect_errno && connect_errno != EINPROGRESS)
                         ? connect_errno
                         : ETIMEDOUT;
      return nullptr;
    }
    usleep(100 * 1000);  // retry rendezvous every 100 ms
  }
}

// ---- messaging -------------------------------------------------------------

static int peer_fd(Endpoint* ep, int peer) {
  if (!ep) return -1;
  if (ep->is_server) {
    if (peer < 1 || static_cast<size_t>(peer) > ep->peers.size()) return -1;
    return ep->peers[static_cast<size_t>(peer - 1)];
  }
  return ep->peers.empty() ? -1 : ep->peers[0];
}

// Send one framed message to peer (server: 1-based client rank; client: 0).
int ft_send(void* handle, int peer, const uint8_t* buf, uint64_t len,
            int timeout_ms) {
  auto* ep = static_cast<Endpoint*>(handle);
  int fd = peer_fd(ep, peer);
  if (fd < 0) return kErrArg;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  uint64_t len_le = htole64(len);
  int rc = send_all(fd, reinterpret_cast<uint8_t*>(&len_le), 8, deadline);
  if (rc < 0) return rc;
  return send_all(fd, buf, len, deadline);
}

// Receive one framed message from peer. *out is malloc'd (caller frees via
// ft_free); *out_len receives the payload size.  Returns 0 or negative error.
int ft_recv(void* handle, int peer, uint8_t** out, uint64_t* out_len,
            int timeout_ms) {
  auto* ep = static_cast<Endpoint*>(handle);
  int fd = peer_fd(ep, peer);
  if (fd < 0 || !out || !out_len) return kErrArg;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  uint64_t len_le = 0;
  int rc = recv_all(fd, reinterpret_cast<uint8_t*>(&len_le), 8, deadline);
  if (rc < 0) return rc;
  uint64_t len = le64toh(len_le);
  uint8_t* buf = static_cast<uint8_t*>(malloc(len ? len : 1));
  if (!buf) return kErrSocket;
  rc = recv_all(fd, buf, len, deadline);
  if (rc < 0) {
    free(buf);
    return rc;
  }
  *out = buf;
  *out_len = len;
  return 0;
}

// Poll a peer for readability WITHOUT consuming bytes: the Python layer
// slices its waits to service heartbeats/reconnects, and consuming a
// partial frame on a slice timeout would corrupt the stream.  Returns 1
// (readable/EOF), 0 (nothing within timeout), or a negative error.
int ft_poll(void* handle, int peer, int timeout_ms) {
  auto* ep = static_cast<Endpoint*>(handle);
  int fd = peer_fd(ep, peer);
  if (fd < 0) return kErrArg;
  int rc = wait_fd(fd, POLLIN, timeout_ms < 0 ? -1 : now_ms() + timeout_ms);
  if (rc == kErrTimeout) return 0;
  if (rc < 0) return rc;
  return 1;
}

void ft_free(uint8_t* buf) { free(buf); }

int ft_n_peers(void* handle) {
  auto* ep = static_cast<Endpoint*>(handle);
  return ep ? static_cast<int>(ep->peers.size()) : 0;
}

void ft_close(void* handle) {
  auto* ep = static_cast<Endpoint*>(handle);
  if (!ep) return;
  for (int fd : ep->peers)
    if (fd >= 0) close(fd);
  if (ep->listen_fd >= 0) close(ep->listen_fd);
  delete ep;
}

}  // extern "C"
