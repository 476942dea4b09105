"""Analytic network model — replaces the paper's ``tc`` emulation.

The paper's testbed: Pixel phone --802.11ac (<=400 Mbps)--> edge Linux box
--tc-shaped link--> cloud Linux box.  We model each link as
(bandwidth, RTT) and compute transfer times analytically so benchmarks can
sweep the same (B_M->E, B_E->C) grid as Fig 2a.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Link:
    bandwidth_mbps: float
    rtt_ms: float = 2.0

    def transfer_ms(self, payload_bytes: float) -> float:
        return self.rtt_ms + payload_bytes * 8.0 / (self.bandwidth_mbps * 1e3)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """mobile<->edge, edge<->edge (peer), metro<->region (federation), and
    edge<->cloud links.

    The peer link models the metro/LAN interconnect between cooperating edge
    nodes: far faster than the WAN to the cloud, slower than staying local —
    the middle rung of the local -> peer -> cloud lookup ladder.

    The region link (``e_r``) carries cross-cluster federation traffic: a
    metro cluster's digest probes and remote payloads travel metro -> region
    -> metro.  It sits between the metro LAN and the WAN in both bandwidth
    and RTT, so the ladder's cost ordering is
    local < peer < remote-cluster < cloud.
    """

    m_e: Link = Link(bandwidth_mbps=400.0, rtt_ms=2.0)      # 802.11ac
    e_e: Link = Link(bandwidth_mbps=1000.0, rtt_ms=1.0)     # edge LAN/metro
    e_r: Link = Link(bandwidth_mbps=400.0, rtt_ms=6.0)      # metro<->region
    e_c: Link = Link(bandwidth_mbps=100.0, rtt_ms=20.0)     # WAN

    def client_to_edge_ms(self, payload_bytes: float) -> float:
        return self.m_e.transfer_ms(payload_bytes)

    def edge_to_client_ms(self, payload_bytes: float) -> float:
        return self.m_e.transfer_ms(payload_bytes)

    def edge_to_edge_ms(self, payload_bytes: float) -> float:
        return self.e_e.transfer_ms(payload_bytes)

    def edge_to_region_ms(self, payload_bytes: float) -> float:
        return self.e_r.transfer_ms(payload_bytes)

    def region_to_edge_ms(self, payload_bytes: float) -> float:
        return self.e_r.transfer_ms(payload_bytes)

    def edge_to_cloud_ms(self, payload_bytes: float) -> float:
        return self.e_c.transfer_ms(payload_bytes)

    def cloud_to_edge_ms(self, payload_bytes: float) -> float:
        return self.e_c.transfer_ms(payload_bytes)
