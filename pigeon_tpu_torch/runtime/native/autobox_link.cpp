// Native autobox transport: UDP message link + lock-free SPSC ring.
//
// TPU-native replacement for the reference's rospy/roscpp pub-sub process
// boundary (SURVEY.md §2 "Native components"; reference
// src/ros_integration.jl:158-169).  The ECU link is a fixed-rate 100 Hz
// datagram stream, so the transport is a plain non-blocking UDP socket
// with packed little-endian frames (no serialization stack on the hot
// path), plus a single-producer/single-consumer ring buffer for
// in-process scenario streaming in benchmark mode.
//
// Built as a shared library and bound from Python via ctypes
// (pigeon_tpu/runtime/transport.py).

#include <arpa/inet.h>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Wire formats (packed little-endian; mirror the reference's from_autobox /
// to_autobox message fields used on the hot path,
// src/ros_integration.jl:50-52,126-133)
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct FromAutoboxWire {
  uint32_t seq;
  double stamp;
  double E_m, N_m, psi_rad, ux_mps, uy_mps, r_radps;
  int32_t pre_flag;
};

struct ToAutoboxWire {
  double stamp;
  int32_t post_flag;
  uint32_t heartbeat;
  double s_m, e_m;
  double delta_cmd_rad, fxf_cmd_N, fxr_cmd_N;
};
#pragma pack(pop)

int ab_from_size() { return (int)sizeof(FromAutoboxWire); }
int ab_to_size() { return (int)sizeof(ToAutoboxWire); }

// ---------------------------------------------------------------------------
// UDP link
// ---------------------------------------------------------------------------

struct Link {
  int sock;
  sockaddr_in peer;
  bool have_peer;
};

// Open a non-blocking UDP endpoint bound to recv_port; peer_host/peer_port
// is where commands go (the autobox).  Returns an opaque handle or 0.
void* ab_open(uint16_t recv_port, const char* peer_host,
              uint16_t peer_port) {
  int s = socket(AF_INET, SOCK_DGRAM, 0);
  if (s < 0) return nullptr;
  int flags = fcntl(s, F_GETFL, 0);
  fcntl(s, F_SETFL, flags | O_NONBLOCK);
  int one = 1;
  setsockopt(s, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));

  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(recv_port);
  if (bind(s, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(s);
    return nullptr;
  }

  Link* l = new Link();
  l->sock = s;
  l->have_peer = peer_host && peer_host[0];
  if (l->have_peer) {
    l->peer = sockaddr_in{};
    l->peer.sin_family = AF_INET;
    l->peer.sin_port = htons(peer_port);
    inet_pton(AF_INET, peer_host, &l->peer.sin_addr);
  }
  return l;
}

// Drain the socket, keeping only the freshest state frame (the controller
// always acts on the latest estimate; queue_size=1 semantics like the
// reference's Subscriber, src/ros_integration.jl:166).
int ab_recv_state(void* h, FromAutoboxWire* out) {
  Link* l = (Link*)h;
  FromAutoboxWire buf;
  int got = 0;
  while (true) {
    ssize_t n = recv(l->sock, &buf, sizeof(buf), 0);
    if (n == (ssize_t)sizeof(buf)) {
      *out = buf;
      got = 1;
    } else {
      break;
    }
  }
  return got;
}

int ab_send_cmd(void* h, const ToAutoboxWire* cmd) {
  Link* l = (Link*)h;
  if (!l->have_peer) return -1;
  ssize_t n = sendto(l->sock, cmd, sizeof(*cmd), 0, (sockaddr*)&l->peer,
                     sizeof(l->peer));
  return n == (ssize_t)sizeof(*cmd) ? 0 : -1;
}

void ab_close(void* h) {
  Link* l = (Link*)h;
  close(l->sock);
  delete l;
}

// ---------------------------------------------------------------------------
// SPSC ring buffer of state frames (in-process scenario streamer for
// benchmark mode; producer = scenario thread, consumer = control loop)
// ---------------------------------------------------------------------------

struct Ring {
  FromAutoboxWire* slots;
  uint32_t capacity;           // power of two
  std::atomic<uint32_t> head;  // producer writes
  std::atomic<uint32_t> tail;  // consumer reads
};

void* ring_create(uint32_t capacity_pow2) {
  Ring* r = new Ring();
  r->capacity = capacity_pow2;
  r->slots = new FromAutoboxWire[capacity_pow2];
  r->head.store(0);
  r->tail.store(0);
  return r;
}

int ring_push(void* h, const FromAutoboxWire* msg) {
  Ring* r = (Ring*)h;
  uint32_t head = r->head.load(std::memory_order_relaxed);
  uint32_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;  // full
  r->slots[head & (r->capacity - 1)] = *msg;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

int ring_pop(void* h, FromAutoboxWire* out) {
  Ring* r = (Ring*)h;
  uint32_t tail = r->tail.load(std::memory_order_relaxed);
  uint32_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return 0;  // empty
  *out = r->slots[tail & (r->capacity - 1)];
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

void ring_destroy(void* h) {
  Ring* r = (Ring*)h;
  delete[] r->slots;
  delete r;
}

}  // extern "C"
