// Length-framed TCP message transport for ccm_slam_tpu_torch (ctypes, plain
// C ABI): the MapMsg protocol between client and server processes (the ROS
// topic replacement; the ack/weak-ack reliability layer lives above it, in
// Python).  A copy of the TCP half of the repository's native/ccm_native.cpp
// with the same framing (an 8-byte little-endian length before each
// message), so the two packages' channels talk to each other.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Framed TCP transport: 8-byte little-endian length prefix per message.
// ---------------------------------------------------------------------------

int ccm_tcp_listen(int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(fd, 16) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int ccm_tcp_accept(int listen_fd) {
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

int ccm_tcp_connect(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

static bool write_all(int fd, const uint8_t* buf, size_t n) {
  while (n > 0) {
    ssize_t w = write(fd, buf, n);
    if (w <= 0) return false;
    buf += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

static bool read_all(int fd, uint8_t* buf, size_t n) {
  while (n > 0) {
    ssize_t r = read(fd, buf, n);
    if (r <= 0) return false;
    buf += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

int ccm_tcp_send_msg(int fd, const uint8_t* buf, int64_t n) {
  uint64_t len = static_cast<uint64_t>(n);
  uint8_t hdr[8];
  memcpy(hdr, &len, 8);
  if (!write_all(fd, hdr, 8)) return -1;
  if (!write_all(fd, buf, static_cast<size_t>(n))) return -1;
  return 0;
}

// Returns the message length, or -1 on error / -2 if it exceeds max_n.
// On -2 the message is consumed and discarded (framing stays intact).
int64_t ccm_tcp_recv_msg(int fd, uint8_t* buf, int64_t max_n) {
  uint8_t hdr[8];
  if (!read_all(fd, hdr, 8)) return -1;
  uint64_t len;
  memcpy(&len, hdr, 8);
  if (static_cast<int64_t>(len) > max_n) {
    std::vector<uint8_t> skip(1 << 16);
    uint64_t left = len;
    while (left > 0) {
      size_t chunk = left < skip.size() ? static_cast<size_t>(left) : skip.size();
      if (!read_all(fd, skip.data(), chunk)) return -1;
      left -= chunk;
    }
    return -2;
  }
  if (!read_all(fd, buf, static_cast<size_t>(len))) return -1;
  return static_cast<int64_t>(len);
}

void ccm_tcp_close(int fd) { close(fd); }

}  // extern "C"
